from .blocks import BNReluConv, PreActConv, UpsampleBlend
from .resnet_pyramid import PyramidResNet, resnet18_pyramid, resnet34_pyramid
from .serving import make_serving_fn, make_stereo_serving_fn
from .stereo import StereoDCSS, build_stereo_model
from .weathernet import WeatherNet, WeatherClassifier, ProjectionHead, DCSSModel, build_model
from .stereo_features import (FeaturePyramid, FeaturePyramidNetwork, GANetFeature, GCNetFeature,
                              MobileNetV2Feature, PSMNetFeature, StereoNetFeature,
                              make_stereo_feature)
from .legacy_segmentation import (DeConv2D, DisparityFeature, SegmentationBranches,
                                  SegmentationDeeplabV3, SimpleSegmentation)
