from panst3r_torch.models.upscalers.loftup import (  # noqa: F401
    LoftUpUpscaler, LoftUpUpscalerConfig)
from panst3r_torch.models.upscalers.pixel_shuffle import (  # noqa: F401
    PixelShuffleUpscaler, PixelShuffleUpscalerConfig)
