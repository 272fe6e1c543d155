"""Model configuration dataclass (copy of ``repro.models.config``).

Kept as a copy because importing ``repro.models`` pulls in JAX.  The
fields, the derived properties, ``param_count``, ``active_param_count``
and ``sliding_variant`` are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Per-layer block kinds (layer_pattern):
#   "A" dense attention + MLP      "M" attention + MoE
#   "S" Mamba2 (SSD) block         "G" shared-weight attention block (zamba2)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads

    # --- attention flavour ---
    causal: bool = True            # False: encoder-only (hubert)
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0        # stablelm uses partial rotary
    qk_norm: bool = False          # qwen3
    sliding_window: Optional[int] = None   # SWA window
    prefix_lm: bool = False        # paligemma: bidirectional prefix
    attn_logit_softcap: float = 0.0  # grok-style soft-capping (0 = off)

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0              # per-expert hidden size
    capacity_factor: float = 1.25
    moe_group_size: int = 2048     # tokens per dispatch group
    router_norm_topk: bool = True  # qwen3 renormalises top-k probs

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # --- layer pattern ---
    # e.g. "A"*24 (dense), "M"*48 (moe), "S"*48 (ssm),
    # zamba2: "SSSSSG" repeating.  len == num_layers.
    layer_pattern: Optional[str] = None

    # --- modality frontends ---
    modality: str = "text"         # text | audio | vlm
    frontend_dim: int = 0          # raw frame/patch embedding dim fed by stub
    num_patches: int = 0           # vlm: vision-prefix length

    # --- misc ---
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    mlp_activation: str = "silu"   # silu (SwiGLU) | gelu | geglu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    activation_dtype: str = "float32"
    remat: bool = False            # checkpoint each block (training)
    unroll_scans: bool = False     # unroll layer scans (FLOPs-audit path)
    kv_cache_dtype: str = "auto"   # auto (=param dtype) | int8
    source: str = ""               # citation for the config

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.layer_pattern is None:
            kind = {"moe": "M", "ssm": "S"}.get(self.arch_type, "A")
            object.__setattr__(self, "layer_pattern", kind * self.num_layers)
        if len(self.layer_pattern) != self.num_layers:
            raise ValueError(
                f"{self.name}: layer_pattern length "
                f"{len(self.layer_pattern)} != num_layers {self.num_layers}")
        if self.num_heads and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: heads not a multiple of kv heads")

    # ---- derived ----
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def attn_layers(self) -> int:
        return sum(1 for c in self.layer_pattern if c in "AMG")

    @property
    def ssm_layers(self) -> int:
        return self.layer_pattern.count("S")

    def param_count(self) -> int:
        """Analytic parameter count (the reference's; norms not
        counted)."""
        d, hd = self.d_model, self.head_dim
        n = self.vocab_size * d           # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d      # lm head
        if self.modality in ("audio", "vlm") and self.frontend_dim:
            n += self.frontend_dim * d
        for kind in self.layer_pattern:
            if kind in ("A", "M", "G"):
                n += d * (self.num_heads * hd) + d * (2 * self.num_kv_heads * hd)
                n += (self.num_heads * hd) * d          # out proj
                mlp_mats = 2 if self.mlp_activation == "gelu" else 3
                if kind == "M":
                    n += d * self.num_experts           # router
                    n += self.num_experts * 3 * d * self.moe_d_ff
                else:
                    n += mlp_mats * d * self.d_ff       # SwiGLU=3 / GELU=2
            elif kind == "S":
                din, st = self.ssm_d_inner, self.ssm_state
                # in_proj emits [z, x, B, C, dt] (single B/C group, G=1)
                n += d * (2 * din + 2 * st + self.ssm_heads)
                n += din * d                             # out proj
                n += self.ssm_conv * (din + 2 * st)
        # shared "G" blocks share one set of weights: subtract duplicates
        g = self.layer_pattern.count("G")
        if g > 1:
            per_g = d * (self.num_heads * hd) + d * (2 * self.num_kv_heads * hd) \
                + (self.num_heads * hd) * d + 3 * d * self.d_ff
            n -= (g - 1) * per_g
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        moe_layers = self.layer_pattern.count("M")
        all_exp = moe_layers * self.num_experts * 3 * self.d_model \
            * self.moe_d_ff
        act_exp = moe_layers * self.experts_per_token * 3 * self.d_model \
            * self.moe_d_ff
        return full - all_exp + act_exp

    def with_updates(self, **kw) -> "ModelConfig":
        if "num_layers" in kw and "layer_pattern" not in kw:
            # re-derive the default pattern for the new depth
            kw["layer_pattern"] = None
        return dataclasses.replace(self, **kw)

    def sliding_variant(self, window: int = 4096) -> "ModelConfig":
        """The documented SWA variant used for long_500k (DESIGN.md §4):
        attention over the last ``window`` positions, a ring cache of
        that many slots."""
        if self.sliding_window is not None and self.sliding_window <= window:
            return self
        return self.with_updates(
            name=self.name + "-swa", sliding_window=window)
