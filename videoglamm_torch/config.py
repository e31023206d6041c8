"""Architecture configs of the port (the fields of videoglamm_tpu/config.py
that the ported modules read, with the same names, defaults and presets).

The port keeps its own copy so that it, and everything that drives it on
the card, imports nothing of the JAX package. `io.from_jax.port_config`
turns a JAX config into these classes; tests/test_torch_models.py holds
the presets equal to the JAX ones.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-L/336 context-image tower."""
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    select_layer: int = -2          # features of hidden_states[select_layer]
    select_feature: str = "patch"   # "patch" drops CLS

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @staticmethod
    def vit_l_336() -> "CLIPVisionConfig":
        return CLIPVisionConfig()

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(image_size=56, patch_size=14, hidden_size=32,
                                num_layers=2, num_heads=2, intermediate_size=64)


@dataclass(frozen=True)
class InternVideo2Config:
    """InternVideo2-1B video tower."""
    image_size: int = 224
    patch_size: int = 14
    embed_dim: int = 1408
    depth: int = 40
    num_heads: int = 16
    mlp_ratio: float = 48.0 / 11.0
    num_frames: int = 4          # frames per chunk (tube)
    tubelet_size: int = 1
    qkv_bias: bool = False
    qk_normalization: bool = True
    init_values: float = 1e-5    # layer-scale init
    rms_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def tokens_per_frame(self) -> int:
        return self.grid * self.grid

    @staticmethod
    def internvideo2_1b() -> "InternVideo2Config":
        return InternVideo2Config()

    @staticmethod
    def tiny() -> "InternVideo2Config":
        return InternVideo2Config(image_size=28, patch_size=14, embed_dim=32,
                                  depth=2, num_heads=2, mlp_ratio=2.0)


@dataclass(frozen=True)
class Phi3Config:
    """Phi-3-mini-4k-instruct decoder."""
    vocab_size: int = 32064
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 96
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5

    @staticmethod
    def phi3_mini_4k() -> "Phi3Config":
        return Phi3Config()

    @staticmethod
    def tiny() -> "Phi3Config":
        return Phi3Config(vocab_size=512, hidden_size=64, intermediate_size=128,
                          num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16)


@dataclass(frozen=True)
class LlamaConfig:
    """Llama-3.1-8B decoder, the alternate LLM base (GQA with 8 KV heads,
    separate q/k/v and gate/up projections, RoPE theta 5e5 with the
    Llama-3.1 frequency rescaling)."""
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5

    @staticmethod
    def llama3_1_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)


@dataclass(frozen=True)
class HieraConfig:
    """SAM-2 Hiera trunk (Hiera-L by default)."""
    embed_dim: int = 144
    num_heads: int = 2
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    global_att_blocks: Tuple[int, ...] = (23, 33, 43)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (7, 7)
    window_spec: Tuple[int, ...] = (8, 4, 16, 8)
    q_pool: int = 3
    dim_mul: float = 2.0
    head_mul: float = 2.0
    mlp_ratio: float = 4.0
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3

    @property
    def channel_list(self) -> Tuple[int, ...]:
        # per-stage output channels, highest stage first (the FPN's order)
        dims = [int(self.embed_dim * self.dim_mul ** i)
                for i in range(len(self.stages))]
        return tuple(reversed(dims))

    @staticmethod
    def hiera_l() -> "HieraConfig":
        return HieraConfig()

    @staticmethod
    def tiny() -> "HieraConfig":
        return HieraConfig(embed_dim=16, num_heads=1, stages=(1, 1, 1, 1),
                           global_att_blocks=(2,), window_spec=(4, 2, 2, 2))


@dataclass(frozen=True)
class SAM2Config:
    """SAM-2: Hiera + FPN, prompt encoder, mask decoder, and the memory
    machinery of the video-branch tracker."""
    hiera: HieraConfig = field(default_factory=HieraConfig.hiera_l)
    image_size: int = 1024
    d_model: int = 256                 # FPN/neck and two-way transformer width
    backbone_scalp: int = 1            # drop the lowest-resolution level
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    # memory machinery
    num_maskmem: int = 7
    mem_dim: int = 64
    memory_attention_layers: int = 4
    memory_attention_dim_feedforward: int = 2048
    memory_rope_theta: float = 10000.0
    max_obj_ptrs_in_encoder: int = 16
    # the memory bank's temporal stride at evaluation (the `r` of XMem)
    memory_temporal_stride_for_eval: int = 1
    # prompted-frame masks are hard-thresholded before memory encoding
    binarize_mask_from_pts_for_mem_enc: bool = True
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    use_high_res_features_in_sam: bool = True
    multimask_output_in_sam: bool = True
    iou_prediction_use_sigmoid: bool = True
    multimask_output_for_tracking: bool = True
    use_multimask_token_for_obj_ptr: bool = True
    dynamic_multimask_via_stability: bool = True
    dynamic_multimask_stability_delta: float = 0.05
    dynamic_multimask_stability_thresh: float = 0.98

    @property
    def backbone_stride(self) -> int:
        return 16

    @property
    def low_res_size(self) -> int:
        return self.image_size // self.backbone_stride  # 64 at 1024

    @staticmethod
    def sam2_hiera_l() -> "SAM2Config":
        return SAM2Config()

    @staticmethod
    def tiny() -> "SAM2Config":
        return SAM2Config(hiera=HieraConfig.tiny(), image_size=128, d_model=32,
                          memory_attention_layers=1,
                          memory_attention_dim_feedforward=64, mem_dim=16)


@dataclass(frozen=True)
class VideoGLaMMConfig:
    """The composite: InternVideo2 + CLIP towers, projectors, the LLM, the
    [SEG] head and SAM-2. llm_type selects the base decoder: "phi3" (the
    default, `llm`) or "llama3_1" (`llama`)."""
    llm_type: str = "phi3"
    llm: Phi3Config = field(default_factory=Phi3Config.phi3_mini_4k)
    llama: LlamaConfig = field(default_factory=LlamaConfig.llama3_1_8b)
    clip: CLIPVisionConfig = field(default_factory=CLIPVisionConfig.vit_l_336)
    internvideo: InternVideo2Config = field(
        default_factory=InternVideo2Config.internvideo2_1b)
    sam2: SAM2Config = field(default_factory=SAM2Config.sam2_hiera_l)
    mm_projector_type: str = "mlp2x_gelu"
    out_dim: int = 256               # [SEG] projection width
    seg_token_idx: int = 32064       # appended after the base vocab
    num_frames: int = 16
    chunk_size: int = 4
    max_seg_tokens: int = 4
    ce_loss_weight: float = 1.0      # loss = ce*1.0 + bce*2.0 + dice*0.5
    bce_loss_weight: float = 2.0
    dice_loss_weight: float = 0.5
    video_pool: Tuple[int, int] = (8, 8)      # 256 -> 64 tokens per frame
    context_pool: Tuple[int, int] = (12, 12)  # 576 -> 144 tokens per frame

    @property
    def llm_config(self):
        """The config of the decoder that `llm_type` names."""
        return self.llm if self.llm_type == "phi3" else self.llama

    @staticmethod
    def flagship() -> "VideoGLaMMConfig":
        return VideoGLaMMConfig()

    @staticmethod
    def tiny(num_frames: int = 4) -> "VideoGLaMMConfig":
        return VideoGLaMMConfig(
            llm=Phi3Config.tiny(),
            clip=CLIPVisionConfig.tiny(),
            internvideo=replace(InternVideo2Config.tiny(), num_frames=2),
            sam2=SAM2Config.tiny(),
            out_dim=32,
            seg_token_idx=500,
            num_frames=num_frames,
            chunk_size=2,
            video_pool=(2, 2),
            context_pool=(2, 2),
        )


@dataclass(frozen=True)
class LoRAConfig:
    """LoRA on the LLM's q and v projections."""
    r: int = 8
    alpha: int = 16
    dropout: float = 0.05
    target_modules: Tuple[str, ...] = ("q_proj", "v_proj")


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters."""
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 5000
    grad_clip: float = 1.0
    micro_batch_size: int = 2
    grad_accum_steps: int = 10
    steps_per_epoch: int = 500
    epochs: int = 10
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    precision: str = "bf16"
