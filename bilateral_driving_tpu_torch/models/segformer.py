"""SegFormer for semantic segmentation (Xie et al., NeurIPS 2021), the
network preprocess/masks.py runs for sky masks.

The JAX package runs it through `transformers`
(bilateral_driving_tpu/preprocess/masks.py:26-59); the port has its own
module, computed as transformers' SegformerForSemanticSegmentation
computes it in eval mode and with its parameter names, so a Hugging Face
state dict loads as it is (convert.segformer_params_from_hf):

- the Mix Transformer encoder: per stage an overlapping patch embedding
  (a strided convolution and a LayerNorm), blocks of efficient
  self-attention (keys and values from the tokens reduced by a strided
  convolution of ratio `sr_ratios[i]` and a LayerNorm; plain matmul and
  softmax) and a Mix-FFN (linear, 3 x 3 depthwise convolution, GELU,
  linear), each pre-normed and residual, and a closing LayerNorm;
- the all-MLP decode head: each stage projected to `decoder_hidden_size`,
  upsampled bilinearly (align_corners=False) to the first stage's size,
  concatenated last stage first, fused by a 1 x 1 convolution, batch norm
  (running statistics), ReLU and a 1 x 1 classifier.

Every LayerNorm takes PyTorch's default eps (1e-5), as transformers'
module does whatever the config's `layer_norm_eps`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
from torch import nn
from torch.nn import functional as F



@dataclasses.dataclass
class SegformerConfig:
    """transformers' SegformerConfig fields the network reads (its
    defaults are segformer-b0's). The published checkpoints' GELU and
    reshaped last stage are the only ones the port computes."""
    num_channels: int = 3
    num_encoder_blocks: int = 4
    depths: List[int] = dataclasses.field(
        default_factory=lambda: [2, 2, 2, 2])
    sr_ratios: List[int] = dataclasses.field(
        default_factory=lambda: [8, 4, 2, 1])
    hidden_sizes: List[int] = dataclasses.field(
        default_factory=lambda: [32, 64, 160, 256])
    patch_sizes: List[int] = dataclasses.field(
        default_factory=lambda: [7, 3, 3, 3])
    strides: List[int] = dataclasses.field(
        default_factory=lambda: [4, 2, 2, 2])
    num_attention_heads: List[int] = dataclasses.field(
        default_factory=lambda: [1, 2, 5, 8])
    mlp_ratios: List[int] = dataclasses.field(
        default_factory=lambda: [4, 4, 4, 4])
    decoder_hidden_size: int = 256
    num_labels: int = 2
    initializer_range: float = 0.02

    @classmethod
    def from_dict(cls, d: dict) -> "SegformerConfig":
        """From a Hugging Face config.json; `num_labels` from `id2label`
        where it is not stated (as PretrainedConfig derives it)."""
        if d.get("hidden_act", "gelu") != "gelu" or not d.get(
                "reshape_last_stage", True):
            raise ValueError("the port's SegFormer computes GELU and a "
                             "reshaped last stage only")
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if "num_labels" not in kw and "id2label" in d:
            kw["num_labels"] = len(d["id2label"])
        return cls(**kw)


# nvidia/segformer-b5-finetuned-cityscapes-1024-1024's config: MiT-b5 and
# the 768-wide head over the 19 cityscapes classes, 1024 x 1024 input
B5_CITYSCAPES = dict(
    depths=[3, 6, 40, 3], hidden_sizes=[64, 128, 320, 512],
    num_attention_heads=[1, 2, 5, 8], decoder_hidden_size=768,
    num_labels=19)
B5_INPUT_HW = (1024, 1024)


class OverlapPatchEmbeddings(nn.Module):
    def __init__(self, patch_size, stride, num_channels, hidden_size):
        super().__init__()
        self.proj = nn.Conv2d(num_channels, hidden_size,
                              kernel_size=patch_size, stride=stride,
                              padding=patch_size // 2)
        self.layer_norm = nn.LayerNorm(hidden_size)

    def forward(self, x):
        x = self.proj(x)
        _, _, height, width = x.shape
        x = x.flatten(2).transpose(1, 2)
        return self.layer_norm(x), height, width


class EfficientSelfAttention(nn.Module):
    def __init__(self, hidden_size, num_heads, sr_ratio):
        super().__init__()
        self.num_heads = num_heads
        self.head_size = hidden_size // num_heads
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)
        self.sr_ratio = sr_ratio
        if sr_ratio > 1:
            self.sr = nn.Conv2d(hidden_size, hidden_size,
                                kernel_size=sr_ratio, stride=sr_ratio)
            self.layer_norm = nn.LayerNorm(hidden_size)

    def _heads(self, x):
        b = x.shape[0]
        return x.view(b, -1, self.num_heads, self.head_size).transpose(1, 2)

    def forward(self, x, height, width):
        b, _, c = x.shape
        q = self._heads(self.query(x))
        if self.sr_ratio > 1:
            x = x.permute(0, 2, 1).reshape(b, c, height, width)
            x = self.sr(x).reshape(b, c, -1).permute(0, 2, 1)
            x = self.layer_norm(x)
        k, v = self._heads(self.key(x)), self._heads(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(
            self.head_size)
        ctx = torch.matmul(F.softmax(scores, dim=-1), v)
        ctx = ctx.permute(0, 2, 1, 3).contiguous()
        return ctx.view(ctx.shape[:-2] + (c,))


class SelfOutput(nn.Module):
    def __init__(self, hidden_size):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)


class Attention(nn.Module):
    def __init__(self, hidden_size, num_heads, sr_ratio):
        super().__init__()
        self.self = EfficientSelfAttention(hidden_size, num_heads, sr_ratio)
        self.output = SelfOutput(hidden_size)

    def forward(self, x, height, width):
        return self.output.dense(self.self(x, height, width))


class DWConv(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, bias=True, groups=dim)

    def forward(self, x, height, width):
        b, _, c = x.shape
        x = self.dwconv(x.transpose(1, 2).view(b, c, height, width))
        return x.flatten(2).transpose(1, 2)


class MixFFN(nn.Module):
    def __init__(self, in_features, hidden_features):
        super().__init__()
        self.dense1 = nn.Linear(in_features, hidden_features)
        self.dwconv = DWConv(hidden_features)
        self.dense2 = nn.Linear(hidden_features, in_features)

    def forward(self, x, height, width):
        x = self.dwconv(self.dense1(x), height, width)
        return self.dense2(F.gelu(x))


class Layer(nn.Module):
    def __init__(self, hidden_size, num_heads, sr_ratio, mlp_ratio):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(hidden_size)
        self.attention = Attention(hidden_size, num_heads, sr_ratio)
        self.layer_norm_2 = nn.LayerNorm(hidden_size)
        self.mlp = MixFFN(hidden_size, int(hidden_size * mlp_ratio))

    def forward(self, x, height, width):
        x = self.attention(self.layer_norm_1(x), height, width) + x
        return self.mlp(self.layer_norm_2(x), height, width) + x


class Encoder(nn.Module):
    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        n = cfg.num_encoder_blocks
        self.patch_embeddings = nn.ModuleList([
            OverlapPatchEmbeddings(
                cfg.patch_sizes[i], cfg.strides[i],
                cfg.num_channels if i == 0 else cfg.hidden_sizes[i - 1],
                cfg.hidden_sizes[i]) for i in range(n)])
        self.block = nn.ModuleList([
            nn.ModuleList([
                Layer(cfg.hidden_sizes[i], cfg.num_attention_heads[i],
                      cfg.sr_ratios[i], cfg.mlp_ratios[i])
                for _ in range(cfg.depths[i])]) for i in range(n)])
        self.layer_norm = nn.ModuleList([
            nn.LayerNorm(cfg.hidden_sizes[i]) for i in range(n)])

    def forward(self, x) -> List[torch.Tensor]:
        """Every stage's output, (B, C_i, H_i, W_i)."""
        b = x.shape[0]
        stages = []
        for embed, blocks, norm in zip(self.patch_embeddings, self.block,
                                       self.layer_norm):
            x, height, width = embed(x)
            for blk in blocks:
                x = blk(x, height, width)
            x = norm(x).reshape(b, height, width, -1).permute(
                0, 3, 1, 2).contiguous()
            stages.append(x)
        return stages


class Backbone(nn.Module):
    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        self.encoder = Encoder(cfg)


class MLP(nn.Module):
    def __init__(self, input_dim, decoder_hidden_size):
        super().__init__()
        self.proj = nn.Linear(input_dim, decoder_hidden_size)

    def forward(self, x):
        return self.proj(x.flatten(2).transpose(1, 2))


class DecodeHead(nn.Module):
    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        d = cfg.decoder_hidden_size
        self.linear_c = nn.ModuleList([
            MLP(cfg.hidden_sizes[i], d)
            for i in range(cfg.num_encoder_blocks)])
        self.linear_fuse = nn.Conv2d(d * cfg.num_encoder_blocks, d,
                                     kernel_size=1, bias=False)
        self.batch_norm = nn.BatchNorm2d(d)
        self.classifier = nn.Conv2d(d, cfg.num_labels, kernel_size=1)

    def forward(self, stages: List[torch.Tensor]) -> torch.Tensor:
        b = stages[-1].shape[0]
        ups = []
        for x, mlp in zip(stages, self.linear_c):
            height, width = x.shape[2], x.shape[3]
            x = mlp(x).permute(0, 2, 1).reshape(b, -1, height, width)
            ups.append(F.interpolate(x, size=stages[0].shape[2:],
                                     mode="bilinear", align_corners=False))
        x = self.linear_fuse(torch.cat(ups[::-1], dim=1))
        return self.classifier(F.relu(self.batch_norm(x)))


class SegformerForSemanticSegmentation(nn.Module):
    """pixel_values (B, 3, H, W) -> logits (B, num_labels, H/4, W/4), in
    eval mode (dropout and drop-path are identities there)."""

    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        self.config = cfg
        self.segformer = Backbone(cfg)
        self.decode_head = DecodeHead(cfg)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.decode_head(self.segformer.encoder(pixel_values))


def init_weights(model: nn.Module,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Random weights drawn as transformers' SegformerPreTrainedModel.
    _init_weights draws them: every Linear and Conv2d weight from
    N(0, initializer_range^2) and its bias 0, every LayerNorm and
    BatchNorm2d weight 1 and bias 0 (running statistics 0 and 1)."""
    std = model.config.initializer_range
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.normal_(0.0, std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return model
