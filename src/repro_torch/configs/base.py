"""Configuration dataclasses (the port's copy of ``repro.configs.base``):
the LLM architectures (``ArchConfig`` and its parts; every arch module
exports one ``CONFIG``, ``ArchConfig.reduced()`` gives its CPU-smoke
variant) and SURF's. ``SparseRecoveryTaskConfig`` arrives with the
sparse-recovery slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    qk_norm: bool = False
    # sliding-window / chunked-local support: ``window`` is the local span;
    # ``pattern_local`` / ``pattern_period`` encode "L locals then
    # (period-L) globals" repeating blocks. pattern_period=0 => all global.
    window: int = 0
    pattern_local: int = 0
    pattern_period: int = 0
    rope_theta: float = 1e6

    @property
    def gqa_groups(self) -> int:
        return self.n_heads // self.n_kv_heads


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0           # shared (always-on) experts
    d_expert: Optional[int] = None  # expert hidden dim (fine-grained MoE); None => d_ff
    every: int = 1              # MoE on layers where (idx % every == every-1); 1 => all
    first_dense: int = 0        # leading dense layers before any MoE
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    kind: str                   # 'mamba' | 'rwkv6'
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    n_heads: int = 32           # rwkv6 heads (d_model // head_size)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    layout: str = "uniform"     # uniform | jamba | gemma3 | llama4 | encdec
    frontend: Optional[str] = None   # 'audio_stub' | 'vision_stub'
    n_encoder_layers: int = 0   # enc-dec only
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "swiglu"         # swiglu | gelu
    tie_embeddings: bool = False
    subquadratic: bool = False  # eligible for long_500k decode
    max_position: int = 131072
    source: str = ""            # citation bracket from the assignment table

    # ---- derived -----------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (embeddings + blocks). Approximate but
        close enough for MODEL_FLOPS = 6*N*D roofline accounting."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb
        layers = self._layer_kinds()
        for kind in layers:
            mixer, ffn = kind
            if mixer == "attn":
                a = self.attn
                total += d * a.n_heads * a.d_head + 2 * d * a.n_kv_heads * a.d_head \
                    + a.n_heads * a.d_head * d
            elif mixer == "ssm":
                s = self.ssm
                di = s.expand * d
                if s.kind == "mamba":
                    total += d * di * 2 + di * d + di * (2 * s.d_state + 1) + di * s.d_conv
                else:  # rwkv6: r,k,v,g,w projections + output
                    total += 5 * d * d + d * d
            if ffn == "dense":
                mult = 3 if self.act == "swiglu" else 2
                total += mult * d * ff
            elif ffn == "moe":
                m = self.moe
                de = m.d_expert or ff
                mult = 3 if self.act == "swiglu" else 2
                n_e = (m.top_k + m.n_shared) if active_only else (m.n_experts + m.n_shared)
                total += n_e * mult * d * de + d * m.n_experts  # + router
        if self.n_encoder_layers:
            a = self.attn
            per_enc = (d * a.n_heads * a.d_head + 2 * d * a.n_kv_heads * a.d_head
                       + a.n_heads * a.d_head * d) + 2 * d * ff  # gelu mlp
            # decoder cross-attention blocks
            per_cross = d * a.n_heads * a.d_head + 2 * d * a.n_kv_heads * a.d_head \
                + a.n_heads * a.d_head * d
            total += self.n_encoder_layers * per_enc + self.n_layers * per_cross
        return int(total)

    def _layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """Sequence of (mixer, ffn) per decoder layer."""
        out = []
        for i in range(self.n_layers):
            if self.layout == "jamba":
                mixer = "attn" if (i % 8 == 4) else "ssm"
                ffn = "moe" if (i % 2 == 1) else "dense"
            elif self.ssm is not None and self.attn is None:
                mixer, ffn = "ssm", "dense"
            else:
                mixer = "attn"
                if self.moe is None or i < self.moe.first_dense:
                    ffn = "dense"
                else:
                    ffn = "moe" if (i % self.moe.every == self.moe.every - 1) else "dense"
            out.append((mixer, ffn))
        return tuple(out)

    def is_global_layer(self, i: int) -> bool:
        """For local/global attention patterns (gemma3, llama4)."""
        a = self.attn
        if a is None or a.pattern_period == 0:
            return True
        return (i % a.pattern_period) >= a.pattern_local

    def reduced(self) -> "ArchConfig":
        """CPU smoke variant of the same family: ≤2 layers, d_model≤512, ≤4 experts."""
        d = min(self.d_model, 256)
        attn = self.attn
        if attn is not None:
            n_h = min(attn.n_heads, 4)
            n_kv = max(1, min(attn.n_kv_heads, n_h if attn.n_kv_heads >= attn.n_heads else 2))
            attn = dataclasses.replace(
                attn, n_heads=n_h, n_kv_heads=n_kv, d_head=d // n_h,
                window=min(attn.window, 8) if attn.window else 0,
                pattern_local=1 if attn.pattern_local else 0,
                pattern_period=2 if attn.pattern_period else 0)
        moe = self.moe
        if moe is not None:
            n_e = min(moe.n_experts, 4)
            k_e = min(moe.top_k, 2)
            # capacity covers the worst case => no token drops; keeps the
            # reduced-config smoke tests (prefill vs decode) deterministic.
            moe = dataclasses.replace(
                moe, n_experts=n_e, top_k=k_e,
                n_shared=min(moe.n_shared, 1), first_dense=min(moe.first_dense, 1),
                d_expert=(d // 2 if moe.d_expert else None),
                capacity_factor=float(n_e) / k_e)
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, d_state=8, n_heads=4)
        n_layers = min(self.n_layers, 8 if self.layout == "jamba" else 2)
        if self.layout == "gemma3":
            n_layers = 2
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=n_layers, d_model=d,
            d_ff=min(self.d_ff, 512), vocab=min(self.vocab, 512), attn=attn,
            moe=moe, ssm=ssm,
            n_encoder_layers=min(self.n_encoder_layers, 2), max_position=4096)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                   # 'train' | 'prefill' | 'decode'


@dataclass(frozen=True)
class TaskConfig:
    """Pure-data description of the inner FL problem the unrolled optimizer
    solves. Subclasses carry the task hyperparameters and the per-agent
    weight dimension; ``repro_torch.core.tasks.resolve_task`` turns one
    into the executable ``Task`` object (losses / metrics)."""
    kind: str = "abstract"

    @property
    def dim(self) -> int:
        raise NotImplementedError


@dataclass(frozen=True)
class ClassificationTaskConfig(TaskConfig):
    """Softmax-classifier head on frozen features (paper §6)."""
    kind: str = "classification"
    feature_dim: int = 64
    n_classes: int = 10

    @property
    def dim(self) -> int:
        return self.feature_dim * self.n_classes + self.n_classes


@dataclass(frozen=True)
class SparseRecoveryTaskConfig(TaskConfig):
    """Federated LASSO (arxiv 2010.12616): per-agent
    ½·mean((A_i w − y_i)²) + ρ‖w‖₁ over a shared k-sparse signal."""
    kind: str = "sparse_recovery"
    signal_dim: int = 32        # p — recovered signal length
    rho: float = 0.02           # ℓ1 penalty weight
    sparsity: int = 4           # nonzeros in the synthetic ground truth
    noise: float = 0.01         # measurement noise std in synthesis
    signal_scale: float = 1.0   # std of the nonzero ground-truth entries

    @property
    def dim(self) -> int:
        return self.signal_dim


@dataclass(frozen=True)
class SURFConfig:
    """Paper-faithful SURF / U-DGD hyperparameters (§6 of the paper)."""
    n_agents: int = 100
    n_layers: int = 10          # L unrolled layers
    filter_taps: int = 2        # K communication rounds per layer
    feature_dim: int = 64       # frozen-feature dim (paper: 512, ResNet18)
    n_classes: int = 10
    batch_per_agent: int = 10   # minibatch fed to each unrolled layer
    train_per_agent: int = 45
    test_per_agent: int = 15
    eps: float = 0.01           # descending-constraint epsilon
    lr_theta: float = 1e-2
    lr_lambda: float = 1e-2
    w0_mean: float = 0.0
    w0_std: float = 0.1
    topology: str = "regular"   # regular | er | star | ring
    degree: int = 3
    er_p: float = 0.1
    # Inner problem. None keeps the legacy classification task built from
    # feature_dim/n_classes above (bit-exact default); any TaskConfig
    # overrides it and makes feature_dim/n_classes inert.
    task: Optional[TaskConfig] = None
    # RSDUN robust descending constraints (arxiv 2312.15788): when
    # robust_sigma > 0 the per-layer grad norms are the max over
    # robust_samples Gaussian perturbations W_l + σδ of the iterates
    # (and the nominal point), tightening the slack the dual ascent sees.
    robust_sigma: float = 0.0
    robust_samples: int = 2
    # Convergence-adaptive depth (solve-time early exit, RSDUN-style
    # certificate): the adaptive solve paths (depth="adaptive" on
    # evaluate_surf / solve_federation / FederationServer) stop unrolling
    # once the probe-batch grad-norm ratio ‖∇f(W_l)‖/‖∇f(W_{l-1})‖
    # plateaus at or above 1 − exit_threshold (i.e. the layer bought less
    # than an exit_threshold fractional descent). exit_threshold == 0
    # disables early exit — the adaptive path then runs all L layers and
    # reproduces the fixed-depth forward exactly. min_layers floors the
    # realized depth; probe_size is the held-aside train rows per agent
    # the certificate is evaluated on (cheap vs the full cohort).
    exit_threshold: float = 0.0
    min_layers: int = 1
    probe_size: int = 4

    @property
    def task_config(self) -> TaskConfig:
        if self.task is not None:
            return self.task
        return ClassificationTaskConfig(feature_dim=self.feature_dim,
                                        n_classes=self.n_classes)

    @property
    def head_dim(self) -> int:
        return self.task_config.dim
