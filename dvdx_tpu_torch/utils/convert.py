"""Diffusers / transformers checkpoints -> the port's pipelines.

Counterpart of ``dvdx_tpu/utils/convert.py``. A diffusers checkpoint
directory

    root/
      model_index.json
      unet/config.json + diffusion_pytorch_model.safetensors (UNet3DConditionModel)
      vae/config.json + diffusion_pytorch_model.safetensors (AutoencoderKL)
      text_encoder/config.json + model.safetensors (CLIPTextModel)
      tokenizer/vocab.json + merges.txt (CLIPTokenizer)

(``.bin`` weights in place of ``.safetensors`` too) is read into float32
numpy state dicts, mapped key for key onto the JAX package's nested
parameter trees (the same trees its converter produces: HWIO convs, (in,
out) dense kernels, ``scale`` for norms), and loaded into the port's
modules by ``utils.bridge``. The mapping is strict both ways: a key the
model needs and the checkpoint lacks raises ``KeyError``, a checkpoint key
no parameter takes raises ``ValueError``.

safetensors files are read (and, for tests and synthetic checkpoints,
written) by this module itself: an 8-byte little-endian header length, a
JSON header of {name: {dtype, shape, data_offsets}}, then the raw bytes.
Nothing here downloads.

    python -m dvdx_tpu_torch.utils.convert --src DIR [--out tree.npz] [--dtype bfloat16]

prints a JSON summary of the checkpoint (spec, parameter counts, tokenizer)
and with ``--out`` writes the converted tree as a flat npz that
``utils.bridge.load_flat_npz`` reads.

A CogVideoX checkpoint (``transformer/`` a ``CogVideoXTransformer3DModel``,
``text_encoder/`` a ``T5EncoderModel``) is recognised by its config classes:
``convert_cogvideox_transformer`` and ``convert_t5_encoder`` map those two
state dicts from their published key names (the dense kernels as views, no
copy, so that a 5.6 B-parameter state dict is not held twice); its 3D causal
VAE has no port, so ``convert_checkpoint`` refuses such a directory.

``convert_lpips`` / ``load_lpips`` read an lpips-package 'alex' state dict
(``.pth`` or safetensors) as the validator's LPIPS metric, as strictly.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.clip_vision import VisionConfig
from ..models.cogvideox import CogVideoXConfig
from ..models.t5 import T5Config
from ..models.text_encoder import TextEncoderConfig
from ..models.unet3d import UNet3DConfig
from ..models.vae import VAEConfig
from ..models.zoo import ModelSpec
from .bridge import load_jax_params, load_lpips_params, load_pipeline_params, unflatten

# --- state-dict files ---------------------------------------------------------

_WEIGHT_FILES = (
    "diffusion_pytorch_model.safetensors",
    "model.safetensors",
    "diffusion_pytorch_model.bin",
    "pytorch_model.bin",
)
# safetensors dtype names -> numpy dtypes; BF16 is read as uint16 and widened
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "BF16": np.uint16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}
_TORCH_ST = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
             torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A safetensors file -> {name: float32 numpy array} (every dtype
    widened to float32, as the reference's loader gives them)."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    n = int.from_bytes(bytes(raw[:8]), "little")
    header = json.loads(bytes(raw[8:8 + n]).decode("utf-8"))
    base = 8 + n
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        kind = info["dtype"]
        if kind not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype {kind}")
        arr = raw[base + begin:base + end].view(np.dtype(_ST_DTYPES[kind]).newbyteorder("<"))
        if kind == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = np.array(arr, dtype=np.float32).reshape(info["shape"])
    return out


def _host_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.ascontiguousarray(v))


def write_safetensors(path: str, tensors: Dict[str, Any]) -> int:
    """{name: torch tensor or numpy array} -> a safetensors file, written
    tensor by tensor (a device tensor is copied to the host when its turn
    comes). Returns the bytes written."""
    header, offset = {}, 0
    for name, v in tensors.items():
        t = _host_tensor(v)
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _TORCH_ST[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for v in tensors.values():
            t = _host_tensor(v).contiguous().cpu()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return 8 + len(blob) + offset


def load_state_dict(component_dir: str) -> Dict[str, np.ndarray]:
    """A component's state dict as float32 numpy: safetensors preferred,
    ``.bin`` through ``torch.load(weights_only=True)``."""
    for name in _WEIGHT_FILES:
        path = os.path.join(component_dir, name)
        if os.path.exists(path):
            break
    else:
        raise FileNotFoundError(f"no weight file in {component_dir!r} "
                                f"(looked for {_WEIGHT_FILES})")
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().to(torch.float32).numpy() for k, v in sd.items()}


def _read_config(component_dir: str) -> dict:
    with open(os.path.join(component_dir, "config.json")) as f:
        return json.load(f)


# --- layout transposes --------------------------------------------------------

def t_conv2d(w: np.ndarray) -> np.ndarray:
    """(O, I, kh, kw) -> (kh, kw, I, O)."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def t_conv3d(w: np.ndarray) -> np.ndarray:
    """(O, I, kt, kh, kw) -> (kt, kh, kw, I, O)."""
    return np.ascontiguousarray(w.transpose(2, 3, 4, 1, 0))


def t_linear(w: np.ndarray) -> np.ndarray:
    """(O, I) -> (I, O)."""
    return np.ascontiguousarray(w.T)


def t_linear_or_conv1x1(w: np.ndarray) -> np.ndarray:
    """A Linear (O, I) or a 1x1 Conv2d (O, I, 1, 1), both dense math."""
    return t_linear(w[:, :, 0, 0] if w.ndim == 4 else w)


class _Mapper:
    """Builds the tree path by path, consuming checkpoint keys, and records
    which keys were used, so that both sides of the mapping are checked."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = sd
        self.used = set()
        self.flat: Dict[str, np.ndarray] = {}

    def take(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"missing checkpoint key {key!r}")
        self.used.add(key)
        return self.sd[key]

    def has(self, key: str) -> bool:
        return key in self.sd

    def put(self, path: str, arr: np.ndarray) -> None:
        self.flat[path] = np.asarray(arr)

    def norm(self, ours: str, hf: str) -> None:
        self.put(f"{ours}/scale", self.take(f"{hf}.weight"))
        self.put(f"{ours}/bias", self.take(f"{hf}.bias"))

    def dense(self, ours: str, hf: str, bias: bool = True, conv1x1: bool = False) -> None:
        tf = t_linear_or_conv1x1 if conv1x1 else t_linear
        self.put(f"{ours}/kernel", tf(self.take(f"{hf}.weight")))
        if bias:
            self.put(f"{ours}/bias", self.take(f"{hf}.bias"))

    def conv2d(self, ours: str, hf: str) -> None:
        self.put(f"{ours}/kernel", t_conv2d(self.take(f"{hf}.weight")))
        self.put(f"{ours}/bias", self.take(f"{hf}.bias"))

    def conv3d(self, ours: str, hf: str) -> None:
        self.put(f"{ours}/kernel", t_conv3d(self.take(f"{hf}.weight")))
        self.put(f"{ours}/bias", self.take(f"{hf}.bias"))

    def unflatten(self) -> Dict[str, Any]:
        return unflatten(self.flat)

    def check_all_used(self, what: str, ignore_prefixes: Tuple[str, ...] = ()) -> None:
        left = sorted(k for k in self.sd if k not in self.used
                      and not any(k.startswith(p) for p in ignore_prefixes))
        if left:
            raise ValueError(f"unconverted {what} keys: {left[:8]}"
                             f"{'...' if len(left) > 8 else ''}")


# --- shared sub-module maps ---------------------------------------------------

def _map_attention(m: _Mapper, ours: str, hf: str) -> None:
    """diffusers Attention: to_q / to_k / to_v without bias, to_out.0 with."""
    for name in ("to_q", "to_k", "to_v"):
        m.dense(f"{ours}/{name}", f"{hf}.{name}", bias=False)
    m.dense(f"{ours}/to_out", f"{hf}.to_out.0")


def _map_basic_block(m: _Mapper, ours: str, hf: str) -> None:
    """diffusers BasicTransformerBlock (both attentions present)."""
    m.norm(f"{ours}/norm1", f"{hf}.norm1")
    _map_attention(m, f"{ours}/attn1", f"{hf}.attn1")
    m.norm(f"{ours}/norm2", f"{hf}.norm2")
    _map_attention(m, f"{ours}/attn2", f"{hf}.attn2")
    m.norm(f"{ours}/norm3", f"{hf}.norm3")
    m.dense(f"{ours}/ff/proj_in", f"{hf}.ff.net.0.proj")
    m.dense(f"{ours}/ff/proj_out", f"{hf}.ff.net.2")


def _map_transformer(m: _Mapper, ours: str, hf: str, conv1x1: bool) -> None:
    """Transformer2DModel (proj_in / proj_out may be 1x1 convs) or
    TransformerTemporalModel (Linear; double self-attention, so attn2 and
    norm2 are always there), one block each."""
    m.norm(f"{ours}/norm", f"{hf}.norm")
    m.dense(f"{ours}/proj_in", f"{hf}.proj_in", conv1x1=conv1x1)
    _map_basic_block(m, f"{ours}/block0", f"{hf}.transformer_blocks.0")
    m.dense(f"{ours}/proj_out_zero", f"{hf}.proj_out", conv1x1=conv1x1)


def _map_resnet(m: _Mapper, ours: str, hf: str, time_emb: bool = True) -> None:
    m.norm(f"{ours}/norm1", f"{hf}.norm1")
    m.conv2d(f"{ours}/conv1", f"{hf}.conv1")
    if time_emb:
        m.dense(f"{ours}/time_emb_proj", f"{hf}.time_emb_proj")
    m.norm(f"{ours}/norm2", f"{hf}.norm2")
    m.conv2d(f"{ours}/conv2", f"{hf}.conv2")
    if m.has(f"{hf}.conv_shortcut.weight"):
        m.conv2d(f"{ours}/{'conv_shortcut' if time_emb else 'shortcut'}",
                 f"{hf}.conv_shortcut")


def _map_temp_conv(m: _Mapper, ours: str, hf: str, num_layers: int) -> None:
    """TemporalConvLayer conv1..convN: (GroupNorm, SiLU, Conv3d) for conv1,
    (GroupNorm, SiLU, Dropout, Conv3d) after it; the last conv is
    zero-initialised."""
    for i in range(num_layers):
        seq = f"{hf}.conv{i + 1}"
        m.norm(f"{ours}/norm{i}", f"{seq}.0")
        name = f"conv{i}_zero" if i == num_layers - 1 else f"conv{i}"
        m.conv3d(f"{ours}/{name}", f"{seq}.{2 if i == 0 else 3}")


# --- UNet3D -------------------------------------------------------------------

def convert_unet3d(sd: Dict[str, np.ndarray], cfg: UNet3DConfig) -> Dict[str, Any]:
    """UNet3DConditionModel state dict -> {'params': tree} (diffusers
    temporal style; the rotary style has no checkpoint)."""
    if cfg.temporal_style != "diffusers":
        raise ValueError("pretrained UNet3D weights need temporal_style="
                         "'diffusers' (rotary has no checkpoint analog)")
    m = _Mapper(sd)
    levels = len(cfg.block_out_channels)
    m.conv2d("conv_in", "conv_in")
    m.dense("time_embedding/fc1", "time_embedding.linear_1")
    m.dense("time_embedding/fc2", "time_embedding.linear_2")
    _map_transformer(m, "transformer_in", "transformer_in", conv1x1=False)

    def level_block(ours: str, hf_block: str, j: int, has_attn: bool):
        _map_resnet(m, f"{ours}/resnet", f"{hf_block}.resnets.{j}")
        _map_temp_conv(m, f"{ours}/temp_conv", f"{hf_block}.temp_convs.{j}",
                       cfg.temporal_conv_layers)
        if has_attn:
            _map_transformer(m, f"{ours}/spatial_attn", f"{hf_block}.attentions.{j}",
                             conv1x1=True)
            _map_transformer(m, f"{ours}/temporal_attn", f"{hf_block}.temp_attentions.{j}",
                             conv1x1=False)

    for level in range(levels):
        for j in range(cfg.layers_per_block):
            level_block(f"down_{level}_{j}", f"down_blocks.{level}", j,
                        cfg.cross_attention_levels[level])
        if level < levels - 1:
            m.conv2d(f"down_{level}_downsample/conv",
                     f"down_blocks.{level}.downsamplers.0.conv")
    # UNetMidBlock3DCrossAttn: mid_0 = (resnets.0, temp_convs.0, attentions.0,
    # temp_attentions.0), mid_1 = (resnets.1, temp_convs.1)
    _map_resnet(m, "mid_0/resnet", "mid_block.resnets.0")
    _map_temp_conv(m, "mid_0/temp_conv", "mid_block.temp_convs.0", cfg.temporal_conv_layers)
    _map_transformer(m, "mid_0/spatial_attn", "mid_block.attentions.0", conv1x1=True)
    _map_transformer(m, "mid_0/temporal_attn", "mid_block.temp_attentions.0", conv1x1=False)
    _map_resnet(m, "mid_1/resnet", "mid_block.resnets.1")
    _map_temp_conv(m, "mid_1/temp_conv", "mid_block.temp_convs.1", cfg.temporal_conv_layers)
    # up_blocks.u is level L-1-u
    for u in range(levels):
        level = levels - 1 - u
        for j in range(cfg.layers_per_block + 1):
            level_block(f"up_{level}_{j}", f"up_blocks.{u}", j,
                        cfg.cross_attention_levels[level])
        if level > 0:
            m.conv2d(f"up_{level}_upsample/conv", f"up_blocks.{u}.upsamplers.0.conv")
    m.norm("conv_norm_out", "conv_norm_out")
    m.conv2d("conv_out_zero", "conv_out")
    m.check_all_used("UNet")
    return {"params": m.unflatten()}


# --- CLIP towers ----------------------------------------------------------------

def _map_clip_layers(m: _Mapper, prefix: str, num_layers: int) -> None:
    for i in range(num_layers):
        lp, ours = f"{prefix}encoder.layers.{i}", f"layer{i}"
        m.norm(f"{ours}/ln1", f"{lp}.layer_norm1")
        for name, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("proj", "out_proj")):
            m.dense(f"{ours}/{name}", f"{lp}.self_attn.{hf}")
        m.norm(f"{ours}/ln2", f"{lp}.layer_norm2")
        m.dense(f"{ours}/fc1", f"{lp}.mlp.fc1")
        m.dense(f"{ours}/fc2", f"{lp}.mlp.fc2")


def convert_text_encoder(sd: Dict[str, np.ndarray],
                         cfg: TextEncoderConfig) -> Dict[str, Any]:
    """transformers CLIPTextModel state dict -> {'params': tree}."""
    m = _Mapper(sd)
    p = "text_model."
    m.put("token_embedding/embedding", m.take(f"{p}embeddings.token_embedding.weight"))
    m.put("position_embedding",
          m.take(f"{p}embeddings.position_embedding.weight")[: cfg.max_length])
    _map_clip_layers(m, p, cfg.num_layers)
    m.norm("final_ln", f"{p}final_layer_norm")
    # position_ids: a buffer in older transformers; the projection and logit
    # scale: CLIP-with-projection checkpoints
    m.check_all_used("text", (f"{p}embeddings.position_ids", "text_projection",
                              "logit_scale"))
    return {"params": m.unflatten()}


def convert_clip_vision(sd: Dict[str, np.ndarray], cfg: VisionConfig) -> Dict[str, Any]:
    """The ``vision_model.`` tree (and ``visual_projection``) of a
    transformers CLIPModel -> {'params': tree} of ``models.clip_vision``."""
    m = _Mapper(sd)
    p = "vision_model."
    m.put("cls_token", m.take(f"{p}embeddings.class_embedding").reshape(1, 1, -1))
    m.put("patch_embed/kernel", t_conv2d(m.take(f"{p}embeddings.patch_embedding.weight")))
    m.put("pos_embedding", m.take(f"{p}embeddings.position_embedding.weight")[None])
    m.norm("pre_ln", f"{p}pre_layrnorm")  # (sic: transformers' key name)
    _map_clip_layers(m, p, cfg.num_layers)
    m.norm("post_ln", f"{p}post_layernorm")
    m.dense("visual_projection", "visual_projection", bias=False)
    m.check_all_used("vision", (f"{p}embeddings.position_ids",))
    return {"params": m.unflatten()}


def load_clip_scorer(root: str, device="cuda"):
    """A transformers CLIPModel checkpoint directory (config.json,
    model.safetensors with both towers and projections, tokenizer files in
    ``tokenizer/`` or beside them) -> ``scoring.clip_score.CLIPScorer`` with
    its weights, CLIP normalisation and BPE tokenizer, float32, on
    ``device``."""
    from ..models.tokenizer import CLIPBPETokenizer
    from ..scoring.clip_score import CLIPScorer

    cfgd = _read_config(root)
    t = cfgd.get("text_config", cfgd)
    v = cfgd.get("vision_config", cfgd)
    text_cfg = TextEncoderConfig(
        vocab_size=t.get("vocab_size", 49408), hidden_size=t.get("hidden_size", 512),
        num_layers=t.get("num_hidden_layers", 12), num_heads=t.get("num_attention_heads", 8),
        intermediate_size=t.get("intermediate_size", 2048),
        max_length=t.get("max_position_embeddings", 77),
        hidden_act=t.get("hidden_act", "quick_gelu"),
        layer_norm_eps=t.get("layer_norm_eps", 1e-5),
        eos_token_id=t.get("eos_token_id", 49407), dtype="float32")
    vision_cfg = VisionConfig(
        image_size=v.get("image_size", 224), patch_size=v.get("patch_size", 32),
        hidden_size=v.get("hidden_size", 768), num_layers=v.get("num_hidden_layers", 12),
        num_heads=v.get("num_attention_heads", 12),
        intermediate_size=v.get("intermediate_size", 3072),
        projection_dim=cfgd.get("projection_dim", 512),
        hidden_act=v.get("hidden_act", "quick_gelu"),
        layer_norm_eps=v.get("layer_norm_eps", 1e-5), dtype="float32")
    sd = load_state_dict(root)
    vision_sd = {k: a for k, a in sd.items()
                 if k.startswith("vision_model.") or k.startswith("visual_projection")}
    text_sd = {k: a for k, a in sd.items()
               if k.startswith("text_model.") or k.startswith("text_projection")
               or k == "logit_scale"}
    tree = {"vision": convert_clip_vision(vision_sd, vision_cfg),
            "text": convert_text_encoder(text_sd, text_cfg),
            "text_proj": t_linear(text_sd["text_projection.weight"])}
    tokenizer = None
    for cand in (os.path.join(root, "tokenizer"), root):
        if os.path.exists(os.path.join(cand, "vocab.json")):
            tokenizer = CLIPBPETokenizer.from_dir(cand)
            break
    with torch.device("meta"):
        scorer = CLIPScorer(vision_cfg, text_cfg, preprocess="clip", tokenizer=tokenizer)
    scorer = scorer.to_empty(device=device)
    return load_jax_params(scorer, tree).eval()


# --- LPIPS(alex), the MD-VQS perceptual metric -----------------------------------

def convert_lpips(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """lpips-package ('alex') state dict -> the JAX package's ``LPIPS.params``
    ({'convK/kernel' HWIO, 'convK/bias', 'linK' (C,), 'shift', 'scale'}).

    Keys: scaling_layer.{shift,scale} (1, 3, 1, 1), optional (the package's
    constants otherwise); net.sliceK.I.{weight,bias}, the torchvision AlexNet
    convs inside the slice Sequentials; linK.model.1.weight (1, C, 1, 1). A
    missing key raises ``KeyError``; a key left over, or a lin head whose
    width is not its conv's, raises ``ValueError``."""
    from ..scoring.lpips import ALEX_LAYERS, LPIPS_SCALE, LPIPS_SHIFT

    m = _Mapper(sd)
    out: Dict[str, np.ndarray] = {}
    out["shift"] = (m.take("scaling_layer.shift").reshape(3)
                    if m.has("scaling_layer.shift") else LPIPS_SHIFT)
    out["scale"] = (m.take("scaling_layer.scale").reshape(3)
                    if m.has("scaling_layer.scale") else LPIPS_SCALE)
    # the conv's position in its slice: slices 2-3 start with the max-pool
    conv_idx = {1: 0, 2: 1, 3: 1, 4: 0, 5: 0}
    for i in range(5):
        k = f"net.slice{i + 1}.{conv_idx[i + 1]}"
        out[f"conv{i}/kernel"] = t_conv2d(m.take(f"{k}.weight"))
        out[f"conv{i}/bias"] = m.take(f"{k}.bias")
        out[f"lin{i}"] = np.ascontiguousarray(m.take(f"lin{i}.model.1.weight").reshape(-1))
        if out[f"lin{i}"].shape[0] != ALEX_LAYERS[i][0]:
            raise ValueError(f"lin{i} width {out[f'lin{i}'].shape} does not "
                             f"match conv{i} channels {ALEX_LAYERS[i][0]}")
    m.check_all_used("LPIPS")
    return out


def load_lpips(path: str, device="cuda"):
    """An LPIPS(alex) checkpoint (a ``.pth`` state dict, a ``.safetensors``
    file, or a directory holding either) -> ``scoring.lpips.LPIPS`` on
    ``device``."""
    from ..scoring.lpips import LPIPS

    if os.path.isdir(path):
        sd = load_state_dict(path)
    elif path.endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        sd = {k: v.detach().to(torch.float32).numpy() for k, v in raw.items()}
    return load_lpips_params(LPIPS().to(device), convert_lpips(sd)).eval()


# --- VAE decoder ----------------------------------------------------------------

def _map_vae_attention(m: _Mapper, ours: str, hf: str) -> None:
    """AutoencoderKL's mid attention, modern (group_norm / to_q / to_out.0)
    or legacy (norm / query / proj_attn) keys."""
    if m.has(f"{hf}.group_norm.weight"):
        m.norm(f"{ours}/norm", f"{hf}.group_norm")
        names = ("to_q", "to_k", "to_v", "to_out.0")
    else:
        m.norm(f"{ours}/norm", f"{hf}.norm")
        names = ("query", "key", "value", "proj_attn")
    for name, hf_name in zip(("q", "k", "v", "proj"), names):
        m.dense(f"{ours}/{name}", f"{hf}.{hf_name}", conv1x1=True)


def convert_vae_decoder(sd: Dict[str, np.ndarray], cfg: VAEConfig) -> Dict[str, Any]:
    """AutoencoderKL (decoder half and post_quant_conv) -> {'params': tree}."""
    m = _Mapper(sd)
    levels = len(cfg.channel_mults)
    m.conv2d("post_quant_conv", "post_quant_conv")
    m.conv2d("conv_in", "decoder.conv_in")
    _map_resnet(m, "mid_res1", "decoder.mid_block.resnets.0", time_emb=False)
    if cfg.use_mid_attention:
        _map_vae_attention(m, "mid_attn", "decoder.mid_block.attentions.0")
    _map_resnet(m, "mid_res2", "decoder.mid_block.resnets.1", time_emb=False)
    for u in range(levels):
        level = levels - 1 - u
        for j in range(cfg.layers_per_block + 1):
            _map_resnet(m, f"up_{level}_{j}", f"decoder.up_blocks.{u}.resnets.{j}",
                        time_emb=False)
        if level > 0:
            m.conv2d(f"up_{level}_conv", f"decoder.up_blocks.{u}.upsamplers.0.conv")
    m.norm("norm_out", "decoder.conv_norm_out")
    m.conv2d("conv_out", "decoder.conv_out")
    m.check_all_used("VAE", ("encoder.", "quant_conv."))
    return {"params": m.unflatten()}


def convert_vae_encoder(sd: Dict[str, np.ndarray], cfg: VAEConfig) -> Dict[str, Any]:
    """AutoencoderKL's encoder half -> {'params': tree} of
    ``models.vae.VAEEncoder`` (the mean path). diffusers gives (mean,
    logvar) through conv_out (2C channels) and then quant_conv (1x1 over
    2C); the encoder emits the mean only, so quant_conv's mean rows are
    folded into conv_out exactly, as the reference folds them:
    W'[o] = sum_c Q[o, c] C[c], b' = Q_b[o] + sum_c Q[o, c] C_b[c]."""
    m = _Mapper(sd)
    levels = len(cfg.channel_mults)
    m.conv2d("conv_in", "encoder.conv_in")
    for i in range(levels):
        for j in range(cfg.layers_per_block):
            _map_resnet(m, f"down_{i}_{j}", f"encoder.down_blocks.{i}.resnets.{j}",
                        time_emb=False)
        if i < levels - 1:
            m.conv2d(f"down_{i}_conv", f"encoder.down_blocks.{i}.downsamplers.0.conv")
    _map_resnet(m, "mid_res1", "encoder.mid_block.resnets.0", time_emb=False)
    if cfg.use_mid_attention:
        _map_vae_attention(m, "mid_attn", "encoder.mid_block.attentions.0")
    _map_resnet(m, "mid_res2", "encoder.mid_block.resnets.1", time_emb=False)
    m.norm("norm_out", "encoder.conv_norm_out")
    cw, cb = m.take("encoder.conv_out.weight"), m.take("encoder.conv_out.bias")
    qw, qb = m.take("quant_conv.weight")[:, :, 0, 0], m.take("quant_conv.bias")
    c = cfg.latent_channels
    m.put("conv_mean/kernel", t_conv2d(np.einsum("oc,cihw->oihw", qw[:c], cw)))
    m.put("conv_mean/bias", qb[:c] + qw[:c] @ cb)
    m.check_all_used("VAE-encoder", ("decoder.", "post_quant_conv."))
    return {"params": m.unflatten()}


# --- CogVideoX: the transformer and its T5 encoder ------------------------------

def _dense_view(m: _Mapper, ours: str, hf: str, bias: bool = True) -> None:
    """A Linear's (O, I) weight as the (I, O) kernel, a view of the array."""
    m.put(f"{ours}/kernel", m.take(f"{hf}.weight").T)
    if bias:
        m.put(f"{ours}/bias", m.take(f"{hf}.bias"))


def convert_cogvideox_transformer(sd: Dict[str, np.ndarray],
                                  cfg: CogVideoXConfig) -> Dict[str, Any]:
    """diffusers ``CogVideoXTransformer3DModel`` state dict -> {'params':
    tree} of ``models.cogvideox.CogVideoXTransformer``: the patch Conv2d
    (C, in, p, p) as a Dense over (in, p, p) patches, ``to_q`` / ``to_k`` /
    ``to_v`` stacked into ``to_qkv``, ``ff.net.0.proj`` / ``ff.net.2`` as
    ``ff.proj_in`` / ``ff.proj_out``, every other module under its own
    name."""
    m = _Mapper(sd)
    w = m.take("patch_embed.proj.weight")
    m.put("patch_embed/kernel", w.reshape(w.shape[0], -1).T)
    m.put("patch_embed/bias", m.take("patch_embed.proj.bias"))
    _dense_view(m, "text_proj", "patch_embed.text_proj")
    _dense_view(m, "time_embedding/fc1", "time_embedding.linear_1")
    _dense_view(m, "time_embedding/fc2", "time_embedding.linear_2")
    for i in range(cfg.num_layers):
        hf, ours = f"transformer_blocks.{i}", f"block{i}"
        for norm in ("norm1", "norm2"):
            _dense_view(m, f"{ours}/{norm}/linear", f"{hf}.{norm}.linear")
            m.norm(f"{ours}/{norm}/norm", f"{hf}.{norm}.norm")
        a = f"{hf}.attn1"
        m.put(f"{ours}/attn1/to_qkv/kernel", np.concatenate(
            [m.take(f"{a}.to_{x}.weight") for x in "qkv"], axis=0).T)
        m.put(f"{ours}/attn1/to_qkv/bias", np.concatenate(
            [m.take(f"{a}.to_{x}.bias") for x in "qkv"], axis=0))
        m.norm(f"{ours}/attn1/norm_q", f"{a}.norm_q")
        m.norm(f"{ours}/attn1/norm_k", f"{a}.norm_k")
        _dense_view(m, f"{ours}/attn1/to_out", f"{a}.to_out.0")
        _dense_view(m, f"{ours}/ff/proj_in", f"{hf}.ff.net.0.proj")
        _dense_view(m, f"{ours}/ff/proj_out", f"{hf}.ff.net.2")
    m.norm("norm_final", "norm_final")
    _dense_view(m, "norm_out/linear", "norm_out.linear")
    m.norm("norm_out/norm", "norm_out.norm")
    _dense_view(m, "proj_out", "proj_out")
    m.check_all_used("CogVideoX transformer")
    return {"params": m.unflatten()}


def convert_t5_encoder(sd: Dict[str, np.ndarray], cfg: T5Config) -> Dict[str, Any]:
    """transformers ``T5EncoderModel`` state dict -> {'params': tree} of
    ``models.t5.T5Encoder`` (``encoder.embed_tokens`` is ``shared``, tied)."""
    m = _Mapper(sd)
    m.put("shared/embedding", m.take("shared.weight"))
    m.put("relative_attention_bias/embedding", m.take(
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"))
    for i in range(cfg.num_layers):
        hf, ours = f"encoder.block.{i}.layer", f"block{i}"
        for x in "qkvo":
            _dense_view(m, f"{ours}/{x}", f"{hf}.0.SelfAttention.{x}", bias=False)
        m.put(f"{ours}/ln1/scale", m.take(f"{hf}.0.layer_norm.weight"))
        for x in ("wi_0", "wi_1", "wo"):
            _dense_view(m, f"{ours}/{x}", f"{hf}.1.DenseReluDense.{x}", bias=False)
        m.put(f"{ours}/ln2/scale", m.take(f"{hf}.1.layer_norm.weight"))
    m.put("final_ln/scale", m.take("encoder.final_layer_norm.weight"))
    m.check_all_used("T5 encoder", ("encoder.embed_tokens.",))
    return {"params": m.unflatten()}


def cogvideox_spec(transformer: dict, text: dict, vae: dict, name: str,
                   dtype: str = "bfloat16") -> ModelSpec:
    """The ModelSpec of a CogVideoX checkpoint's transformer, T5 and VAE
    config.json dicts: the published transformer and text tower; the port's
    per-frame KL decoder at the VAE's published widths, latent channels and
    scaling factor; the CogVideoX DDIM schedule."""
    t = transformer
    den = CogVideoXConfig(
        in_channels=t["in_channels"], out_channels=t.get("out_channels") or t["in_channels"],
        num_layers=t["num_layers"], num_heads=t["num_attention_heads"],
        head_dim=t["attention_head_dim"], time_embed_dim=t["time_embed_dim"],
        text_embed_dim=t["text_embed_dim"], patch_size=t["patch_size"],
        norm_eps=t.get("norm_eps", 1e-5), sample_height=t.get("sample_height", 60),
        sample_width=t.get("sample_width", 90), dtype=dtype)
    t5 = T5Config(
        vocab_size=text["vocab_size"], d_model=text["d_model"], d_kv=text["d_kv"],
        num_heads=text["num_heads"], d_ff=text["d_ff"], num_layers=text["num_layers"],
        relative_attention_num_buckets=text.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=text.get("relative_attention_max_distance", 128),
        layer_norm_epsilon=text.get("layer_norm_epsilon", 1e-6),
        max_length=t.get("max_text_seq_length", 226), dtype=dtype)
    chs = vae["block_out_channels"]
    dec = VAEConfig(
        latent_channels=vae.get("latent_channels", 16), base_channels=chs[0],
        channel_mults=tuple(c // chs[0] for c in chs),
        layers_per_block=vae.get("layers_per_block", 3), norm_groups=vae.get("norm_num_groups", 32),
        use_mid_attention=False, final_tanh=False, scaling_factor=vae.get("scaling_factor", 0.7),
        dtype=dtype)
    return ModelSpec(name=name, kind="cogvideox", dit=den, text=t5, vae=dec,
                     prediction_type="v_prediction", default_width=720, default_height=480,
                     default_frames=13, default_steps=50, default_guidance_scale=6.0)


# --- spec and pipeline ------------------------------------------------------------

def spec_from_diffusers_configs(root: str, name: Optional[str] = None,
                                dtype: str = "bfloat16") -> ModelSpec:
    """A ModelSpec from the checkpoint's own config.json files: a UNet3D
    checkpoint's, or a CogVideoX checkpoint's (``transformer/`` a
    ``CogVideoXTransformer3DModel``, ``text_encoder/`` a ``T5EncoderModel``)."""
    if os.path.exists(os.path.join(root, "transformer", "config.json")):
        t = _read_config(os.path.join(root, "transformer"))
        text = _read_config(os.path.join(root, "text_encoder"))
        if t.get("_class_name") != "CogVideoXTransformer3DModel" or \
                "T5EncoderModel" not in text.get("architectures", ["T5EncoderModel"]):
            raise ValueError(f"{root}: transformer {t.get('_class_name')!r} with text encoder "
                             f"{text.get('architectures')}: not a CogVideoX checkpoint")
        return cogvideox_spec(t, text, _read_config(os.path.join(root, "vae")),
                              name or os.path.basename(os.path.normpath(root)), dtype)
    u = _read_config(os.path.join(root, "unet"))
    v = _read_config(os.path.join(root, "vae"))
    t = _read_config(os.path.join(root, "text_encoder"))
    blocks = tuple(u["block_out_channels"])
    down_types = u.get("down_block_types",
                       ["CrossAttnDownBlock3D"] * (len(blocks) - 1) + ["DownBlock3D"])
    head_dim = u.get("attention_head_dim", 64)
    if isinstance(head_dim, (list, tuple)):
        head_dim = head_dim[0]
    unet = UNet3DConfig(
        in_channels=u.get("in_channels", 4), out_channels=u.get("out_channels", 4),
        block_out_channels=blocks, layers_per_block=u.get("layers_per_block", 2),
        cross_attention_levels=tuple("CrossAttn" in b for b in down_types),
        attention_head_dim=int(head_dim),
        cross_attention_dim=u.get("cross_attention_dim", 1024),
        norm_groups=u.get("norm_num_groups", 32), norm_eps=u.get("norm_eps", 1e-5),
        temporal_conv_layers=4, temporal_style="diffusers", dtype=dtype)
    base = v["block_out_channels"][0]
    vae = VAEConfig(
        latent_channels=v.get("latent_channels", 4), base_channels=base,
        channel_mults=tuple(c // base for c in v["block_out_channels"]),
        layers_per_block=v.get("layers_per_block", 2), norm_groups=v.get("norm_num_groups", 32),
        final_tanh=False, scaling_factor=v.get("scaling_factor", 0.18215), dtype=dtype)
    text = TextEncoderConfig(
        vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
        num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
        intermediate_size=t["intermediate_size"],
        max_length=t.get("max_position_embeddings", 77), hidden_act=t.get("hidden_act", "gelu"),
        layer_norm_eps=t.get("layer_norm_eps", 1e-5), eos_token_id=t.get("eos_token_id", 49407),
        dtype=dtype)
    return ModelSpec(name=name or os.path.basename(os.path.normpath(root)),
                     text=text, vae=vae, unet=unet)


def convert_checkpoint(root: str, spec: ModelSpec) -> Dict[str, Any]:
    """The checkpoint's three components -> the reference's
    ``Pipeline.params`` tree ({'unet', 'text', 'vae_dec'}) of float32
    numpy arrays."""
    if spec.kind == "cogvideox":
        raise NotImplementedError(
            f"{root}: the CogVideoX 3D causal VAE (AutoencoderKLCogVideoX) has no port; "
            "convert its transformer and text encoder with convert_cogvideox_transformer "
            "and convert_t5_encoder")
    return {
        "unet": convert_unet3d(load_state_dict(os.path.join(root, "unet")), spec.unet),
        "text": convert_text_encoder(load_state_dict(os.path.join(root, "text_encoder")),
                                     spec.text),
        "vae_dec": convert_vae_decoder(load_state_dict(os.path.join(root, "vae")), spec.vae),
    }


def load_diffusers_checkpoint(root: str, name: Optional[str] = None,
                              dtype: str = "bfloat16", device="cuda"):
    """A diffusers checkpoint directory -> a ``Pipeline`` on ``device`` with
    its weights (cast once to ``dtype``) and the checkpoint's CLIP BPE
    tokenizer (the hash tokenizer when it has no ``tokenizer/``)."""
    from ..models.tokenizer import CLIPBPETokenizer
    from ..pipelines.text2video import empty_pipeline

    spec = spec_from_diffusers_configs(root, name=name, dtype=dtype)
    tok_dir = os.path.join(root, "tokenizer")
    tokenizer = (CLIPBPETokenizer.from_dir(tok_dir)
                 if os.path.exists(os.path.join(tok_dir, "vocab.json")) else None)
    pipe = empty_pipeline(spec, device, tokenizer)
    return load_pipeline_params(pipe, convert_checkpoint(root, spec))


def save_flat_npz(path: str, tree: Dict[str, Any]) -> None:
    """A nested tree of numpy arrays -> the flat npz ``utils.bridge.
    load_flat_npz`` reads (keys ``name/path|dtype|shape`` over raw bytes)."""
    flat = {}

    def walk(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            a = np.ascontiguousarray(node)
            flat[f"{prefix}|{a.dtype.name}|{','.join(map(str, a.shape))}"] = a.view(np.uint8)

    walk(tree)
    np.savez(path, **flat)


def main(argv=None) -> int:
    """Converter CLI: a JSON summary of a checkpoint, and with ``--out`` the
    converted tree as a flat npz."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m dvdx_tpu_torch convert",
                                 description="diffusers checkpoint -> dvdx_tpu_torch")
    ap.add_argument("--src", required=True, help="diffusers checkpoint directory")
    ap.add_argument("--out", default="", help="write the converted tree (flat npz)")
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)

    from ..models.tokenizer import CLIPBPETokenizer

    spec = spec_from_diffusers_configs(args.src, dtype=args.dtype)
    tree = convert_checkpoint(args.src, spec)
    has_tok = os.path.exists(os.path.join(args.src, "tokenizer", "vocab.json"))

    def count(node):
        return sum(count(v) for v in node.values()) if isinstance(node, dict) else node.size

    summary = {"model": spec.name, "unet_params": count(tree["unet"]),
               "text_params": count(tree["text"]), "vae_dec_params": count(tree["vae_dec"]),
               "tokenizer": "clip-bpe" if has_tok else "hash-fallback",
               "vocab_size": spec.text.vocab_size,
               "block_out_channels": list(spec.unet.block_out_channels),
               "cross_attention_dim": spec.unet.cross_attention_dim, "dtype": args.dtype}
    if has_tok:
        CLIPBPETokenizer.from_dir(os.path.join(args.src, "tokenizer"))
    if args.out:
        save_flat_npz(args.out, tree)
        summary["out"] = args.out
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
