"""Model presets (counterpart of panst3r_tpu/models/presets.py): v1
(PixelShuffle upscaler, no input mixer) at full width, and the tiny CI
config.  The v2 presets wait for the v2 slice."""
from __future__ import annotations

from panst3r_torch.models.decoder import MemoryDecoderConfig
from panst3r_torch.models.dino import DinoEncoderConfig
from panst3r_torch.models.encoder import ViTEncoderConfig
from panst3r_torch.models.mask_transformer import MaskTransformerConfig
from panst3r_torch.models.panoptic_decoder import PanopticDecoderConfig
from panst3r_torch.models.panst3r import PanSt3RConfig
from panst3r_torch.models.upscalers import PixelShuffleUpscalerConfig


def panst3r_v1_config(**overrides) -> PanSt3RConfig:
    return PanSt3RConfig(
        encoder=ViTEncoderConfig(),        # ViT-L/16, dim 1024, depth 24
        decoder=MemoryDecoderConfig(),     # dim 768, depth 12
        dino=DinoEncoderConfig(),          # dinov2-large
        panoptic=PanopticDecoderConfig(
            upscaler=PixelShuffleUpscalerConfig(),
            mask_transformer=MaskTransformerConfig(
                hidden_dim=768, ff_dim=2048, mask_dim=256, num_queries=200,
                num_heads=8, dec_layers=6, lang_dim=768, fpn_dims=(768,)),
        ),
        **overrides,
    )


def tiny_config(**overrides) -> PanSt3RConfig:
    """Small config for CI."""
    return PanSt3RConfig(
        encoder=ViTEncoderConfig(embed_dim=64, depth=2, num_heads=4),
        decoder=MemoryDecoderConfig(enc_dim=64, dim=48, depth=2, num_heads=4),
        dino=DinoEncoderConfig(embed_dim=32, depth=1, num_heads=2,
                               pos_grid=5),
        panoptic=PanopticDecoderConfig(
            upscaler=PixelShuffleUpscalerConfig(fp_dim=(32, 24, 16, 8)),
            mask_transformer=MaskTransformerConfig(
                hidden_dim=32, ff_dim=64, mask_dim=8, num_queries=16,
                num_heads=4, dec_layers=2, lang_dim=24, fpn_dims=(32,)),
        ),
        **overrides,
    )
