"""The super-resolution stage of the port (counterpart of
imagine360_tpu/sr/): the enhancer and its two refiner engines (the pano
UNet branch, the VEnhancer V2V UNet), the tiled and chunked decode and the
wavelet colour fix. The decode and the colour fix work on channel-first
videos [F, C, H, W]; the enhancer takes and returns [F, H, W, 3] frames and
keeps its latents channels-last [F, h, w, 4], as the models do."""
from .enhance import EnhancerConfig, EnhancerNoise, Video360Enhancer
from .refiner import PanoRefiner, PanoRefinerConfig
from .tiled_decode import gaussian_weights_2d, tiled_chunked_decode
from .unet_v2v import (ControlledV2VUNet, V2VConfig, V2VRefiner, Vid2VidSDUNet,
                       VideoControlNet, tiny_v2v_config)
from .wavelet_fix import wavelet_color_fix
