from panst3r_torch.models.upscalers.pixel_shuffle import (  # noqa: F401
    PixelShuffleUpscaler, PixelShuffleUpscalerConfig)
