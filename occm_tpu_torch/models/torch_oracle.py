"""Pure torch-functional wav2vec2 forward (features_only): the independent
oracle that `occm_tpu_torch.cli.parity_gate` holds a converted checkpoint
against (the port's own copy of `occm_tpu.models.torch_oracle`).

No fairseq dependency: the semantics the converter targets (conv extractor
with a LayerNorm after every block, or wav2vec2-base's GroupNorm after the
first; feature LayerNorm and projection; the weight-normed positional conv
with its SamePad trim; pre- or post-norm transformer layers; the encoder
LayerNorm; reference: models/xlsr.py:29-52 wraps the fairseq model this
reproduces), written with torch.nn.functional on a fairseq-named state
dict, independently of the port's modules. The positional conv's weight
norm is folded by the port's `fold_weight_norm`. Everything runs in fp32
on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.models.xlsr import fold_weight_norm


def torch_wav2vec2_oracle(sd: dict, wave: np.ndarray, cfg: XLSRConfig
                          ) -> np.ndarray:
    """features_only wav2vec2 forward in torch functional ops (fp32):
    sd a fairseq-named state dict (tensors or arrays), wave [B, T] ->
    [B, frames, encoder_embed_dim]."""
    sd = {k: (v.float() if hasattr(v, "float") else torch.tensor(v))
          for k, v in sd.items()}
    C = cfg.conv_layers[-1][0]
    D = cfg.encoder_embed_dim
    H = cfg.encoder_heads
    hd = D // H

    h = torch.tensor(np.asarray(wave, np.float32))[:, None, :]
    for i, (dim, k, s) in enumerate(cfg.conv_layers):
        h = F.conv1d(
            h, sd[f"feature_extractor.conv_layers.{i}.0.weight"],
            sd.get(f"feature_extractor.conv_layers.{i}.0.bias"), stride=s,
        )
        if cfg.extractor_mode == "layer_norm":
            h = h.transpose(1, 2)
            h = F.layer_norm(
                h, (dim,),
                sd[f"feature_extractor.conv_layers.{i}.2.1.weight"],
                sd[f"feature_extractor.conv_layers.{i}.2.1.bias"],
            )
            h = h.transpose(1, 2)
        elif i == 0:
            h = F.group_norm(
                h, dim, sd["feature_extractor.conv_layers.0.2.weight"],
                sd["feature_extractor.conv_layers.0.2.bias"],
            )
        h = F.gelu(h)
    h = h.transpose(1, 2)
    h = F.layer_norm(h, (C,), sd["layer_norm.weight"], sd["layer_norm.bias"])
    if "post_extract_proj.weight" in sd:
        h = h @ sd["post_extract_proj.weight"].T + sd["post_extract_proj.bias"]

    w = fold_weight_norm(sd["encoder.pos_conv.0.weight_g"],
                         sd["encoder.pos_conv.0.weight_v"])
    pos = F.conv1d(
        h.transpose(1, 2), w, sd["encoder.pos_conv.0.bias"],
        padding=cfg.conv_pos // 2, groups=cfg.conv_pos_groups,
    )
    if cfg.conv_pos % 2 == 0:
        pos = pos[..., :-1]
    x = h + F.gelu(pos).transpose(1, 2)

    def ln(x, name):
        return F.layer_norm(x, (D,), sd[f"{name}.weight"], sd[f"{name}.bias"])

    def dense(x, name):
        return x @ sd[f"{name}.weight"].T + sd[f"{name}.bias"]

    if not cfg.layer_norm_first:
        x = ln(x, "encoder.layer_norm")

    for l in range(cfg.encoder_layers):
        pre = f"encoder.layers.{l}"
        res = x
        z = (ln(x, f"{pre}.self_attn_layer_norm") if cfg.layer_norm_first
             else x)
        q = dense(z, f"{pre}.self_attn.q_proj")
        k = dense(z, f"{pre}.self_attn.k_proj")
        v = dense(z, f"{pre}.self_attn.v_proj")
        B, T, _ = z.shape
        q = q.view(B, T, H, hd).transpose(1, 2) * (hd ** -0.5)
        k = k.view(B, T, H, hd).transpose(1, 2)
        v = v.view(B, T, H, hd).transpose(1, 2)
        att = torch.softmax(q @ k.transpose(-2, -1), dim=-1)
        z = (att @ v).transpose(1, 2).reshape(B, T, D)
        x = res + dense(z, f"{pre}.self_attn.out_proj")
        if not cfg.layer_norm_first:
            x = ln(x, f"{pre}.self_attn_layer_norm")

        res = x
        z = (ln(x, f"{pre}.final_layer_norm") if cfg.layer_norm_first
             else x)
        z = dense(F.gelu(dense(z, f"{pre}.fc1")), f"{pre}.fc2")
        x = res + z
        if not cfg.layer_norm_first:
            x = ln(x, f"{pre}.final_layer_norm")

    if cfg.layer_norm_first:
        x = ln(x, "encoder.layer_norm")
    return x.numpy()
