"""OpenCV's 3×3 chamfer distance transform, for every label of a map at once.

JAX's ``LabelBoundaryTransform`` (``data/transforms.py:198-207``) runs
``cv2.distanceTransform(labels == c, cv2.DIST_L2, 3)`` once per class and
keeps each class's distances on its own pixels. This module gives those
distances without cv2, in one pass over the map, as OpenCV's own code
computes them (``imgproc/src/distransform.cpp``, ``distanceTransform_3x3``):

- two raster passes of 32-bit fixed point with 16 fraction bits; the
  horizontal / vertical step weighs ``cvRound(0.955 · 2¹⁶)`` = 62587, the
  diagonal ``cvRound(1.3693 · 2¹⁶)`` = 89738;
- the forward pass takes the up-left, up, up-right and left neighbours,
  the backward pass the pixel's own value and its down-right, down,
  down-left and right neighbours;
- the frame around the image is far, not background: it holds the
  saturation value ``2³² − 1 − 89738``, at which every distance is also
  clamped (OpenCV 5: a pixel with no zero of its mask reads 65534.63);
- the result is the unsigned sum converted to float32, times 2⁻¹⁶.

A pixel lies in exactly one class mask, so in class c's pass every pixel
of another label is a zero of the mask. One label-aware pass therefore
gives every class's distances: a neighbour of another label counts as
distance 0, a neighbour of the same label with its running value.

The row recurrence ``t[j] = min(c[j], t[j-1] + 62587)``, where ``c`` is
the best of the row above, is a running minimum within each run of one
label: ``t[j] = min_k (c[k] − 62587·k) + 62587·j`` over the run's ``k ≤
j``. Offsetting each run by a multiple of 2³⁴ makes one
``np.minimum.accumulate`` over the row restart at each run, exactly, in
int64. Rows stay sequential: each reads the finished row before it.

With IPP (the default of the ``opencv-python`` wheels on x86), cv2 takes
``ippiDistanceTransform_3x3_8u32f_C1R`` instead, which sums in float32 in
an order set by the CPU's vector width; its distances differ from the
fixed-point ones by up to 5.3e-6 of their value. The fixed-point code is
the one whose bits do not depend on the machine, so that is the one
copied here; the tests hold this module to cv2 with IPP off, bit for bit,
and to the IPP route within a stated bound. On a mask without a zero the
two routes part wholesale (65534.63 against IPP's FLT_MAX):
``LabelBoundaryTransform`` gives such a map IPP's value.
"""

from __future__ import annotations

import numpy as np

HV_DIST = 62587                      # cvRound(0.955f * 65536)
DIAG_DIST = 89738                    # cvRound(1.3693f * 65536)
DIST_MAX = (1 << 32) - 1 - DIAG_DIST  # the frame and the saturation value
_SCALE = np.float32(1.0 / (1 << 16))
_HUGE = 1 << 62                      # never the minimum
_RUN = 1 << 34                       # offset between runs: > DIST_MAX + DIAG_DIST


def _forward(labels: np.ndarray, init) -> np.ndarray:
    """One raster pass (top to bottom, left to right) of the label-aware
    3×3 chamfer, each pixel's value also at most ``init``'s (the backward
    pass gives the forward values here). Returns int64, clamped."""
    h, w = labels.shape
    lab = labels.astype(np.int32)
    # a neighbour of another label contributes its weight (distance 0 +
    # the step); one of the same label, or the frame, its running value
    cap_ul = np.full((h, w), _HUGE, np.int64)
    cap_u = np.full((h, w), _HUGE, np.int64)
    cap_ur = np.full((h, w), _HUGE, np.int64)
    cap_ul[1:, 1:][lab[:-1, :-1] != lab[1:, 1:]] = DIAG_DIST
    cap_u[1:][lab[:-1] != lab[1:]] = HV_DIST
    cap_ur[1:, :-1][lab[:-1, 1:] != lab[1:, :-1]] = DIAG_DIST
    # the left neighbour: at a run's first pixel it has another label (or
    # is the frame); inside a run it is the running minimum below
    run_start = np.ones((h, w), bool)
    run_start[:, 1:] = lab[:, 1:] != lab[:, :-1]
    first = np.where(run_start, HV_DIST, _HUGE)
    first[:, 0] = DIST_MAX + HV_DIST
    if init is not None:
        np.minimum(first, init, out=first)
    offset = np.arange(w, dtype=np.int64) * HV_DIST + np.cumsum(run_start, axis=1) * _RUN

    # t[i + 1, 1:-1] is row i; row 0 and the two side columns are the frame
    t = np.full((h + 1, w + 2), DIST_MAX, np.int64)
    c = np.empty(w, np.int64)
    tmp = np.empty(w, np.int64)
    for i in range(h):
        up = t[i]
        np.add(up[:-2], DIAG_DIST, out=c)
        np.minimum(c, cap_ul[i], out=c)
        np.add(up[1:-1], HV_DIST, out=tmp)
        np.minimum(tmp, cap_u[i], out=tmp)
        np.minimum(c, tmp, out=c)
        np.add(up[2:], DIAG_DIST, out=tmp)
        np.minimum(tmp, cap_ur[i], out=tmp)
        np.minimum(c, tmp, out=c)
        np.minimum(c, first[i], out=c)
        c -= offset[i]
        np.minimum.accumulate(c, out=c)
        c += offset[i]
        np.minimum(c, DIST_MAX, out=t[i + 1, 1:-1])
    return t[1:, 1:-1]


def label_chamfer_distance(labels) -> np.ndarray:
    """Float32 (H, W): each pixel's 3×3 chamfer distance to the nearest
    pixel of another label, as ``cv2.distanceTransform((labels == l)
    .astype(np.uint8), cv2.DIST_L2, 3)`` gives it on the pixels of label
    ``l`` (OpenCV's fixed-point route), for every label at once."""
    labels = np.asarray(labels)
    if labels.ndim != 2:
        raise ValueError(f"label_chamfer_distance: an (H, W) label map, got {labels.shape}")
    fwd = _forward(labels, None)
    # the backward pass is the forward pass of the map turned by 180°
    both = _forward(labels[::-1, ::-1], fwd[::-1, ::-1])[::-1, ::-1]
    return both.astype(np.float32) * _SCALE
