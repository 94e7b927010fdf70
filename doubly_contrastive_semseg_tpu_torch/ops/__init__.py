from .interpolate import downsample_bicubic_direct, resize_bilinear
from .input_pipeline import build_pyramid, normalize, upsample4x_argmax
from .seghead import fused_seghead_upsample_argmax, seghead_reference
from .stem import fused_stem_pool, stem_pool_reference
