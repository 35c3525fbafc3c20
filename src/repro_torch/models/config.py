"""ModelConfig — the dataclass describing an architecture, and ShardCfg.

The port's copy of ``repro.models.config``: the same fields and derived
dimensions, with ``param_dtype``/``compute_dtype`` as ``torch.dtype``.
``param_count`` counts the port's own parameters (a model built on the
``meta`` device, which allocates nothing).

``ShardCfg`` holds the distribution posture: ``LOCAL`` (one device), or a
mesh of ranks (``dist.sharding.make_shard_cfg``: FSDP×TP or pure data
parallelism) with ``moe_mode`` ``local``, ``tp`` or ``a2a``, and
sequence-parallel Mamba2 (``ssm_sp``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

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
        """Active parameters per token (MoE: the routed experts' parameters
        count at ``num_experts_per_tok / num_experts``; the router and the
        shared experts count in full)."""
        from repro_torch.models import model

        total = expert_total = 0
        lm = model.init_params(self, device="meta")
        for name, p in lm.named_parameters():
            total += p.numel()
            if "experts" in name.split("."):
                expert_total += p.numel()
        if not self.num_experts:
            return total
        active_frac = self.num_experts_per_tok / self.num_experts
        return total - expert_total + int(expert_total * active_frac)


@dataclasses.dataclass(frozen=True)
class ShardCfg:
    """Distribution decisions, threaded through the model code.

    ``mesh=None`` is the single-device path: every constraint is the
    identity and no collective runs.  With a mesh of ranks
    (``launch.mesh.make_mesh``) ``dp``/``tp`` name its axes (``dp`` may be a
    tuple, e.g. ``("pod", "data")``), as in the reference; each rank holds
    its block of every tensor, so a constraint is the identity here too and
    the layers that are tensor-parallel call the collectives of
    :mod:`repro_torch.dist.collectives` themselves.  ``moe_mode``:

      local — every rank computes every expert (the experts' leaves are
              gathered for their use)
      tp    — the experts sharded over ``tp``; activations replicated on
              ``tp``; the combine is one all-reduce a layer
      a2a   — the experts sharded over ``tp``; each ``tp`` rank routes its
              block of the sequence, and the dispatch buffers go to their
              experts' ranks and back in two all_to_alls a layer
              (``models.moe._a2a_moe``)

    ``ssm_sp``: each Mamba2 block runs on the ``tp`` rank's block of the
    sequence, with the conv halo and the chunk state relayed from the
    ranks before it (``models.mamba2._mamba2_seq_sp``).  On a mesh,
    ``moe_mode`` ``tp`` or ``a2a`` and ``ssm_sp`` need a ``tp`` axis: they
    raise without one rather than run as something else.
    """

    mesh: Any = None
    dp: Any = "data"
    tp: str | None = "model"
    moe_mode: str = "local"
    ssm_sp: bool = False
    batch_sharded: bool = True     # False when global batch < |dp|
    replicate_params: bool = False # pure data parallelism, one grad mean

    def __post_init__(self):
        if self.moe_mode not in ("local", "tp", "a2a"):
            raise ValueError(f"unknown moe_mode {self.moe_mode!r}")
        if self.mesh is not None and self.tp is None:
            if self.moe_mode in ("tp", "a2a"):
                raise ValueError(f"moe_mode={self.moe_mode!r} shards the "
                                 "experts over a tensor-parallel axis; this "
                                 "posture has none (tp=None)")
            if self.ssm_sp:
                raise ValueError("ssm_sp splits the sequence over a "
                                 "tensor-parallel axis; this posture has "
                                 "none (tp=None)")

    @property
    def dp_axes(self) -> tuple:
        return self.dp if isinstance(self.dp, tuple) else (self.dp,)

    def act_spec(self, *trailing):
        """Placement of a (B, ...) activation: the batch over ``dp``."""
        if self.mesh is None:
            return None
        batch = self.dp if self.batch_sharded else None
        return (batch, *trailing)

    def constrain(self, x, spec=None):
        return x

    def constrain_act(self, x, *trailing):
        return self.constrain(x, self.act_spec(*trailing))

    # -- the tensor-parallel axis of this rank ---------------------------------
    def tp_size(self) -> int:
        """|tp| of a sharded posture (1 without a mesh, a ``tp`` axis, or
        with replicated parameters)."""
        if self.mesh is None or self.tp is None or self.replicate_params:
            return 1
        from repro_torch.launch.mesh import mesh_extents

        return mesh_extents(self.mesh)[self.tp]

    def tp_rank(self) -> int:
        from repro_torch.dist.collectives import coordinate

        return coordinate(self.mesh)[self.tp] if self.tp_size() > 1 else 0

    def dp_size(self) -> int:
        """|dp| of a sharded posture (1 without a mesh)."""
        if self.mesh is None:
            return 1
        from repro_torch.launch.mesh import mesh_extents

        ext = mesh_extents(self.mesh)
        return math.prod(ext[a] for a in self.dp_axes)

    def data_parallel(self) -> bool:
        """Whether the model's own code sees more than one data rank's rows
        (the ``fsdp_tp`` posture with the batch split over ``dp``; ``dp``
        runs the model under ``LOCAL``)."""
        return (self.mesh is not None and not self.replicate_params
                and self.batch_sharded and self.dp_size() > 1)


LOCAL = ShardCfg(mesh=None, moe_mode="local")


class KVBlock(NamedTuple):
    """The part of the attention KV caches' sequence a rank holds when the
    model serves over a mesh whose tensor-parallel axis is larger than 1
    (``dist.sharding.local_caches``): positions [start, start + the block's
    length).  ``split``: the sequence is split over ``tp``, one block a
    rank (``cache_spec_tree``'s rule); else every ``tp`` rank holds it all
    (start 0), as the rule's guard leaves a length that does not divide."""

    start: int
    split: bool
