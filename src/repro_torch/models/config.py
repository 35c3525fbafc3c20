"""ModelConfig — the dataclass describing an architecture, and ShardCfg.

The port's copy of ``repro.models.config``: the same fields and derived
dimensions, with ``param_dtype``/``compute_dtype`` as ``torch.dtype``.
``param_count`` counts the port's own parameters (a model built on the
``meta`` device, which allocates nothing).

``ShardCfg`` keeps only the single-device posture, ``LOCAL``: every
constraint is the identity.  A mesh, sequence-parallel Mamba2 or a MoE
mode other than ``local`` raises ``NotImplementedError`` (ROADMAP queue 1,
items 9 and 11).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # --- SSM / Mamba2 (hybrid) ----------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0            # hybrid: shared attn+MLP block period

    # --- xLSTM ---------------------------------------------------------------
    slstm_indices: tuple = ()
    mlstm_proj_factor: float = 2.0
    slstm_unroll: int = 1

    # --- modality stubs -------------------------------------------------------
    num_codebooks: int = 0
    num_prefix_tokens: int = 0

    # --- numerics / memory -----------------------------------------------------
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    remat: str = "block"           # training only; the serving path ignores it
    q_chunk: int = 1024
    kv_chunk: int = 1 << 30
    scan_layers: bool = True       # the port always loops over layers

    # --- capability flags -------------------------------------------------------
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived dims -----------------------------------------------------
    @property
    def d_inner(self) -> int:               # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:              # channels fed through causal conv
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    def param_count(self) -> int:
        """Total parameters of the port's model for this config."""
        from repro_torch.models import model

        return sum(p.numel() for p in
                   model.init_params(self, device="meta").parameters())

    def active_param_count(self) -> int:
        """Active parameters per token: every parameter, for the families
        the port takes (the reference counts only routed experts of a MoE,
        whose family is ROADMAP queue 1, item 11)."""
        if self.num_experts:
            raise not_ported("active parameters of a MoE config", 11)
        return self.param_count()


def not_ported(what: str, item: int | str) -> NotImplementedError:
    """The error for a part of the LM stack the port does not take yet."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item {item})")


@dataclasses.dataclass(frozen=True)
class ShardCfg:
    """Distribution decisions; the port takes only the single-device one."""

    mesh: Any = None
    moe_mode: str = "local"
    ssm_sp: bool = False

    def __post_init__(self):
        if self.mesh is not None:
            raise not_ported("a device mesh", 9)
        if self.ssm_sp:
            raise not_ported("sequence-parallel Mamba2 (ssm_sp, "
                             "_mamba2_seq_sp)", 9)
        if self.moe_mode != "local":
            raise not_ported(f"moe_mode={self.moe_mode!r}", 11)

    def constrain(self, x, spec=None):
        return x

    def constrain_act(self, x, *trailing):
        return x


LOCAL = ShardCfg()
