"""The DeepLab family's backbones. Each takes an NCHW (channels_last) image
tensor and returns ``{"low_level": ..., "out": ...}`` as NCHW tensors."""
