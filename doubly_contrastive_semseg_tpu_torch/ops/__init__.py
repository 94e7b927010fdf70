from .blend import blend_kernel_supported, fused_upsample_blend, upsample_blend_reference
from .contrastive import (contrastive_row_stats, contrastive_row_stats_reference,
                          pixel_contrast_loss_kernel, pixel_contrast_pos_sweep,
                          pixel_contrast_sweep_reference, supcon_loss_kernel)
from .interpolate import downsample_bicubic_direct, resize_bilinear, resize_nearest
from .input_pipeline import build_pyramid, normalize, upsample4x_argmax
from .seghead import fused_seghead_upsample_argmax, seghead_reference
from .stem import fused_stem_pool, stem_pool_reference
