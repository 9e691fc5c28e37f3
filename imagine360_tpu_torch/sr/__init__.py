"""The super-resolution stage of the port (counterpart of
imagine360_tpu/sr/): so far the tiled, temporally chunked decode and the
wavelet colour fix. Videos are channel-first, [F, C, H, W]."""
from .tiled_decode import gaussian_weights_2d, tiled_chunked_decode
from .wavelet_fix import wavelet_color_fix
