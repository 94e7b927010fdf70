from .combine import SEG_WEIGHT, compute_total_loss, weather_classifier_metrics
from .focal import boundary_aware_focal_loss, cross_entropy_loss
from .pixel_contrast import pixel_contrast_loss
from .supcon import KERNEL_MIN_N, supcon_loss
from .disparity import PYRAMID_WEIGHTS, disparity_loss, smoothness_loss
