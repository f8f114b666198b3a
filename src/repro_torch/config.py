"""Configuration of the PyTorch/CUDA port.

Copies of the JAX package's ``SolverConfig``, ``EnergyConfig``, model,
shape, mesh, train and run dataclasses, architecture registry and the
launch scripts' CLI helpers: the port keeps its own so that it imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Tuple


@dataclass(frozen=True)
class SolverConfig:
    """Dirac-inversion solver knobs (the paper's C1 workload: CL2QCD's
    even-odd preconditioned, mixed-precision CG).

    ``inner_dtype`` is the storage/traffic precision of the inner
    (defect-correction) CG; ``"none"`` disables mixed precision and runs
    the whole solve at working precision.  Dtypes are strings so the
    configuration does not depend on a framework.
    """

    preconditioner: str = "even_odd"   # none | even_odd
    inner_dtype: str = "bfloat16"      # none | bfloat16 | float16 | float32
    tol: float = 1e-6
    max_iters: int = 1000
    inner_tol: float = 1e-2            # reliable-update restart threshold
    max_outer: int = 30

    _INNER_DTYPES = ("none", "", "float32", "bfloat16", "float16", "float64")

    def __post_init__(self):
        if self.preconditioner not in ("none", "even_odd"):
            raise ValueError(f"unknown preconditioner {self.preconditioner!r}")
        if self.inner_dtype not in self._INNER_DTYPES:
            raise ValueError(f"unknown inner_dtype {self.inner_dtype!r}; "
                             f"one of {self._INNER_DTYPES}")

    @property
    def mixed_precision(self) -> bool:
        return self.inner_dtype not in ("none", "", "float32")


@dataclass(frozen=True)
class EnergyConfig:
    """Energy-plan settings (the paper's technique, C3/C5)."""

    enabled: bool = True
    mode: str = "efficiency"      # performance | efficiency
    max_perf_loss: float = 0.015  # paper: D-slash loses <1.5%
    freq_grid: Tuple[float, ...] = tuple(round(0.5 + 0.025 * i, 3) for i in range(21))


# ---------------------------------------------------------------------------
# Model configuration: copies of the JAX package's ``repro/config.py``
# dataclasses and architecture registry.
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (capacity-based dispatch)."""

    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0          # per-expert hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.001

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""

    q_lora_rank: int = 0          # 0 = no q compression
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 style SSD (state-space duality) configuration."""

    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    # hybrid (hymba): number of SSM heads running parallel to attention
    n_groups: int = 1

    @property
    def enabled(self) -> bool:
        return self.d_state > 0


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description covering all assigned families."""

    name: str
    family: str                   # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0               # 0 -> d_model // n_heads
    moe: MoEConfig = MoEConfig()
    mla: MLAConfig = MLAConfig()
    ssm: SSMConfig = SSMConfig()
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0       # 0 = full attention
    # MLP details
    mlp_variant: str = "swiglu"   # swiglu | gelu | relu2 | geglu
    norm_variant: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    tie_embeddings: bool = False
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_ratio: int = 4        # dec_len / enc_len for the audio stub
    # modality frontend stub
    frontend: str = "none"        # none | audio | vlm
    n_patches: int = 0            # vlm: patch embeddings prepended
    # numerics
    dtype: str = "bfloat16"
    # provenance of the published configuration
    source: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.d_head == 0 and self.n_heads > 0:
            object.__setattr__(self, "d_head",
                               self.d_model // max(self.n_heads, 1))

    # -- derived sizes ------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 (Megatron-style); the logits
        mask the padded tail."""
        return -(-self.vocab_size // 256) * 256

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm.enabled else 0

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm.head_dim if self.ssm.enabled else 0

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model FLOPs)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        # attention
        if not self.attn_free:
            if self.mla.enabled:
                m = self.mla
                qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
                q_in = m.q_lora_rank if m.q_lora_rank else d
                per_layer += (d * m.q_lora_rank if m.q_lora_rank else 0)
                per_layer += q_in * self.n_heads * qk_dim
                per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                per_layer += m.kv_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                per_layer += self.n_heads * m.v_head_dim * d
            else:
                dh = self.d_head
                per_layer += d * self.n_heads * dh            # Q
                per_layer += 2 * d * self.n_kv_heads * dh     # K, V
                per_layer += self.n_heads * dh * d            # O
                if self.qkv_bias:
                    per_layer += (self.n_heads + 2 * self.n_kv_heads) * dh
        # ssm (pure or hybrid)
        if self.ssm.enabled:
            di, ds = self.d_inner_ssm, self.ssm.d_state
            nh = self.n_ssm_heads
            per_layer += d * (2 * di + 2 * self.ssm.n_groups * ds + nh)
            per_layer += di * self.ssm.d_conv                  # conv
            per_layer += nh * 2                                # A, D
            per_layer += di * d                                # out_proj
        # mlp / moe
        if self.moe.enabled:
            e = self.moe
            per_layer += d * e.n_experts                        # router
            per_layer += e.n_experts * 3 * d * e.expert_d_ff    # experts
            per_layer += e.n_shared_experts * 3 * d * e.expert_d_ff
        elif self.d_ff > 0:
            mult = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
            per_layer += mult * d * self.d_ff
        # norms (rms scale): negligible but counted
        if self.norm_variant != "nonparametric_ln":
            per_layer += 2 * d
        total = emb + L * per_layer
        if self.n_encoder_layers:
            mult = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
            enc_layer = 4 * d * d + mult * d * self.d_ff
            total += self.n_encoder_layers * enc_layer
            total += self.n_layers * 4 * d * d  # decoder cross-attention
        return total

    def active_param_count(self) -> int:
        """Active (per-token) params: differs from total only for MoE."""
        if not self.moe.enabled:
            return self.param_count()
        e = self.moe
        dense_like = replace(
            self, moe=MoEConfig(),
            d_ff=e.expert_d_ff * (e.top_k + e.n_shared_experts),
            mlp_variant="swiglu")
        return dense_like.param_count() + self.n_layers * self.d_model \
            * e.n_experts


# ---------------------------------------------------------------------------
# Shapes (the four assigned input shapes)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(model: ModelConfig,
                     shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs; returns (ok, reason-if-skipped)."""
    if shape.name == "long_500k":
        sub_quadratic = model.family in ("ssm", "hybrid") \
            or model.sliding_window > 0
        if not sub_quadratic:
            return False, ("pure full-attention arch: 500k decode requires "
                           "sub-quadratic attention (assignment: skip)")
    return True, ""


# ---------------------------------------------------------------------------
# Mesh / run configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    """A logical device mesh: the shape the sharding rules
    (``distributed.sharding``) and the analytic roofline divide work
    over.  ``launch.mesh.make_mesh_from_config`` builds the
    single-controller ``LMMesh`` that runs it."""

    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axis_names

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in ("pod", "data"))

    @property
    def data_size(self) -> int:
        return self.n_devices // self.model_size

    @property
    def model_size(self) -> int:
        return self.shape[self.axis_names.index("model")]


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))
MULTI_POD_MESH = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    remat: str = "layer"          # none | layer | block (sqrt-remat)
    microbatches: int = 1         # grad-accumulation steps per global batch
    moment_dtype: str = "float32"  # AdamW m/v storage (bf16 for huge models)
    grad_accum_dtype: str = "float32"
    grad_compress: bool = False   # int8 cross-pod DP compression
    seed: int = 0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = SINGLE_POD_MESH
    train: TrainConfig = TrainConfig()
    energy: EnergyConfig = EnergyConfig()


# ---------------------------------------------------------------------------
# Architecture registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    full: Callable[[], ModelConfig]
    smoke: Callable[[], ModelConfig]


ARCH_REGISTRY: Dict[str, ArchEntry] = {}

# every architecture the JAX package registers, each with its config
# module; the port's models serve every one of them
ARCH_IDS: List[str] = [
    "whisper-small",
    "grok-1-314b",
    "deepseek-v2-236b",
    "qwen1.5-32b",
    "minitron-8b",
    "olmo-1b",
    "llama3-8b",
    "mamba2-370m",
    "llava-next-mistral-7b",
    "hymba-1.5b",
]

_MODULE_FOR_ID = {
    "whisper-small": "whisper_small",
    "grok-1-314b": "grok1_314b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen1.5-32b": "qwen15_32b",
    "minitron-8b": "minitron_8b",
    "olmo-1b": "olmo_1b",
    "llama3-8b": "llama3_8b",
    "mamba2-370m": "mamba2_370m",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "hymba-1.5b": "hymba_1_5b",
}


def register_arch(arch_id: str, full: Callable[[], ModelConfig],
                  smoke: Callable[[], ModelConfig]) -> None:
    ARCH_REGISTRY[arch_id] = ArchEntry(arch_id, full, smoke)


def _ensure_loaded(arch_id: str) -> None:
    if arch_id in ARCH_REGISTRY:
        return
    mod = _MODULE_FOR_ID.get(arch_id)
    if mod is None:
        raise KeyError(f"unknown architecture {arch_id!r}; known: {ARCH_IDS}")
    importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(arch_id: str) -> ArchEntry:
    _ensure_loaded(arch_id)
    return ARCH_REGISTRY[arch_id]


def full_config(arch_id: str) -> ModelConfig:
    return get_arch(arch_id).full()


def smoke_config(arch_id: str) -> ModelConfig:
    return get_arch(arch_id).smoke()


def all_cells() -> List[Tuple[str, str]]:
    """All 40 (arch, shape) cells, including SKIP cells."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES]


# ---------------------------------------------------------------------------
# Small CLI helper shared by launch scripts
# ---------------------------------------------------------------------------

def add_common_args(parser) -> None:
    parser.add_argument("--arch", choices=ARCH_IDS, required=True)
    parser.add_argument("--shape", choices=list(SHAPES), default="train_4k")
    parser.add_argument("--multi-pod", action="store_true")
    parser.add_argument("--smoke", action="store_true",
                        help="use the reduced smoke config")


def run_config_from_args(args) -> RunConfig:
    entry = get_arch(args.arch)
    model = entry.smoke() if args.smoke else entry.full()
    mesh = MULTI_POD_MESH if args.multi_pod else SINGLE_POD_MESH
    return RunConfig(model=model, shape=SHAPES[args.shape], mesh=mesh)


def asdict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
