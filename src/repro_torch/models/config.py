"""Model and shape configuration dataclasses (pure data).

Port of ``repro/models/config.py``: the port keeps its own copy so that it
imports nothing of the JAX package.  The fields, defaults, ``SHAPES`` and the
analytic parameter counts are the reference's, unchanged."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0
    n_shared_experts: int = 0  # DeepSeekMoE shared experts
    d_ff_shared: int = 0  # total shared-expert hidden size
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    norm_topk_prob: bool = True
    first_dense_layers: int = 0  # DeepSeekMoE: leading dense layers
    d_ff_dense: int = 0  # hidden size of those dense layers


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # mamba1; 0 = d_model // 16
    head_p: int = 64  # mamba2 head size
    version: int = 1  # 1 = mamba1 (falcon-mamba), 2 = mamba2/SSD (zamba2)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 = d_model // n_heads
    act: str = "swiglu"  # swiglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    # hybrid (zamba2): one shared transformer block reused every attn_every
    # mamba blocks
    attn_every: int = 0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    max_target_len: int = 448
    # vlm: fraction of the sequence that is (stubbed) image patch embeddings
    n_img_tokens: int = 0

    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- analytic parameter / FLOP counts (roofline MODEL_FLOPS) ------------

    def param_count(self) -> int:
        d, f, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd, nq, nkv = self.hd(), self.n_heads, self.n_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (nq + 2 * nkv) + nq * hd * d
        mlp_sw = 3 * d * f
        mlp_ge = 2 * d * f
        mlp = mlp_sw if self.act == "swiglu" else mlp_ge
        if self.family == "dense":
            return emb + L * (attn + mlp + 2 * d) + d
        if self.family == "moe":
            m = self.moe
            route = d * m.n_experts
            emoe = 3 * d * m.d_ff_expert * m.n_experts
            shared = 3 * d * m.d_ff_shared if m.d_ff_shared else 0
            dense_l = m.first_dense_layers
            dense_mlp = 3 * d * (m.d_ff_dense or f)
            return (
                emb
                + dense_l * (attn + dense_mlp + 2 * d)
                + (L - dense_l) * (attn + emoe + shared + route + 2 * d)
                + d
            )
        if self.family == "ssm":
            s = self.ssm
            din = s.expand * d
            dtr = s.dt_rank or d // 16
            per = (
                d * 2 * din  # in_proj
                + din * s.d_conv  # conv
                + din * (dtr + 2 * s.d_state)  # x_proj
                + dtr * din  # dt_proj
                + din * s.d_state  # A
                + din * 2  # D, dt bias-ish
                + din * d  # out_proj
            )
            return emb + L * (per + d) + d
        if self.family == "hybrid":
            s = self.ssm
            din = s.expand * d
            nh = din // s.head_p
            per = (
                d * 2 * din
                + din * s.d_conv
                + din * 2 * s.d_state  # B, C projections (folded into in_proj
                + nh * 3  # in real mamba2; kept separate here)
                + din * d
                + d
            )
            shared = attn + mlp + 2 * d
            return emb + self.n_layers * per + shared + d
        if self.family == "encdec":
            Le, Ld = self.n_enc_layers, self.n_dec_layers
            enc = Le * (attn + mlp_ge + 2 * d)
            dec = Ld * (2 * attn + mlp_ge + 3 * d)
            return emb + enc + dec + 2 * d + self.max_target_len * d
        if self.family == "vlm":
            return emb + L * (attn + mlp + 2 * d) + d
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d, f, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd, nq, nkv = self.hd(), self.n_heads, self.n_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (nq + 2 * nkv) + nq * hd * d
        active_moe = 3 * d * m.d_ff_expert * m.top_k + 3 * d * m.d_ff_shared
        dense_l = m.first_dense_layers
        dense_mlp = 3 * d * (m.d_ff_dense or f)
        return (
            emb
            + dense_l * (attn + dense_mlp + 2 * d)
            + (L - dense_l) * (attn + active_moe + d * m.n_experts + 2 * d)
            + d
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatch: int = 0  # per-DP-shard microbatch for grad accumulation;
    # 0 = no accumulation (single microbatch)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
