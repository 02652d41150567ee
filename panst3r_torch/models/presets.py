"""Model presets (counterpart of panst3r_tpu/models/presets.py): v1
(PixelShuffle upscaler, no input mixer) and v2 (InputMixer + LoftUp
upscaler, mask_dim 384) at full width, and their tiny CI configs."""
from __future__ import annotations

from panst3r_torch.models.decoder import MemoryDecoderConfig
from panst3r_torch.models.dino import DinoEncoderConfig
from panst3r_torch.models.encoder import ViTEncoderConfig
from panst3r_torch.models.input_mixer import InputMixerConfig
from panst3r_torch.models.mask_transformer import MaskTransformerConfig
from panst3r_torch.models.panoptic_decoder import PanopticDecoderConfig
from panst3r_torch.models.panst3r import PanSt3RConfig
from panst3r_torch.models.upscalers import (LoftUpUpscalerConfig,
                                            PixelShuffleUpscalerConfig)


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
            label_mode="sigmoid",
        ),
        **overrides,
    )


def panst3r_v2_config(**overrides) -> PanSt3RConfig:
    return PanSt3RConfig(
        encoder=ViTEncoderConfig(),
        decoder=MemoryDecoderConfig(),
        dino=DinoEncoderConfig(),
        panoptic=PanopticDecoderConfig(
            input_mixer=InputMixerConfig(hidden_dim=768, num_heads=12,
                                         num_layers=3),
            upscaler=LoftUpUpscalerConfig(dim=384, output_stride=2),
            mask_transformer=MaskTransformerConfig(
                hidden_dim=768, ff_dim=2048, mask_dim=384, num_queries=200,
                num_heads=8, dec_layers=6, lang_dim=768, fpn_dims=(768,)),
            label_mode="sigmoid",
        ),
        **overrides,
    )


def tiny_v2_config(**overrides) -> PanSt3RConfig:
    """Small v2-shaped config (InputMixer + LoftUp) for CI."""
    return PanSt3RConfig(
        encoder=ViTEncoderConfig(embed_dim=64, depth=2, num_heads=4),
        decoder=MemoryDecoderConfig(enc_dim=64, dim=48, depth=2, num_heads=4),
        dino=DinoEncoderConfig(embed_dim=32, depth=1, num_heads=2,
                               pos_grid=5),
        panoptic=PanopticDecoderConfig(
            input_mixer=InputMixerConfig(hidden_dim=32, num_heads=2,
                                         num_layers=1),
            upscaler=LoftUpUpscalerConfig(dim=16, n_freqs=4, num_heads=2,
                                          num_layers=1),
            mask_transformer=MaskTransformerConfig(
                hidden_dim=32, ff_dim=64, mask_dim=16, num_queries=16,
                num_heads=4, dec_layers=2, lang_dim=24, fpn_dims=(32,)),
            label_mode="sigmoid",
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
