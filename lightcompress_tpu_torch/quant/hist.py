"""Histogram-based static range calibration (``static_hist``; the port's
own numpy copy of lightcompress_tpu/quant/hist.py).

The KL-style histogram threshold search for per-tensor symmetric static
act quant: a histogram of every calibration batch (re-binned as the range
grows), then the quantile narrowing whose quantization error stops
falling.  One-time host work in numpy (float64); the batches may be
tensors on any device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .spec import QuantSpec

UPSAMPLE_RATE = 16


def _numpy(b) -> np.ndarray:
    if hasattr(b, "detach"):  # a torch tensor, on any device
        b = b.detach().float().cpu().numpy()
    return np.asarray(b, dtype=np.float64)


def _get_norm(delta_begin, delta_end, density):
    norm = (delta_end**3 - delta_begin**3) / 3
    return density * norm


def _quantization_error(histogram, min_val, max_val, next_start_bin,
                        next_end_bin, bins, dst_nbins):
    bin_width = (max_val - min_val) / bins
    dst_bin_width = bin_width * (next_end_bin - next_start_bin + 1) \
        / dst_nbins
    if dst_bin_width == 0.0:
        return 0.0
    src_bin = np.arange(bins)
    src_bin_begin = (src_bin - next_start_bin) * bin_width
    src_bin_end = src_bin_begin + bin_width
    dst_bin_of_begin = np.clip(
        np.floor(src_bin_begin / dst_bin_width), 0, dst_nbins - 1
    )
    dst_bin_of_begin_center = (dst_bin_of_begin + 0.5) * dst_bin_width
    dst_bin_of_end = np.clip(
        np.floor(src_bin_end / dst_bin_width), 0, dst_nbins - 1
    )
    density = histogram / bin_width
    norm = np.zeros(bins)
    delta_begin = src_bin_begin - dst_bin_of_begin_center
    delta_end = dst_bin_width / 2
    norm += _get_norm(delta_begin, np.full(bins, delta_end), density)
    norm += (dst_bin_of_end - dst_bin_of_begin - 1) * _get_norm(
        -dst_bin_width / 2, dst_bin_width / 2, density
    )
    dst_bin_of_end_center = dst_bin_of_end * dst_bin_width + dst_bin_width / 2
    delta_begin = -dst_bin_width / 2
    delta_end = src_bin_end - dst_bin_of_end_center
    norm += _get_norm(delta_begin, delta_end, density)
    return float(norm.sum())


def _hist_threshold(histogram, min_val, max_val, bins, dst_nbins):
    """Iterative quantile narrowing (quant.py:403-460)."""
    bin_width = (max_val - min_val) / bins
    total = histogram.sum()
    csum = np.cumsum(histogram)
    stepsize = 1e-5
    alpha, beta = 0.0, 1.0
    start_bin, end_bin = 0, bins - 1
    norm_min = float("inf")
    while alpha < beta:
        next_alpha = alpha + stepsize
        next_beta = beta - stepsize
        left, right = start_bin, end_bin
        while left < end_bin and csum[left] < next_alpha * total:
            left += 1
        while right > start_bin and csum[right] > next_beta * total:
            right -= 1
        next_start_bin, next_end_bin = start_bin, end_bin
        if (left - start_bin) > (end_bin - right):
            next_start_bin = left
            alpha = next_alpha
        else:
            next_end_bin = right
            beta = next_beta
        if next_start_bin == start_bin and next_end_bin == end_bin:
            continue
        norm = _quantization_error(histogram, min_val, max_val,
                                   next_start_bin, next_end_bin, bins,
                                   dst_nbins)
        if norm > norm_min:
            break
        norm_min = norm
        start_bin, end_bin = next_start_bin, next_end_bin
    new_min = min_val + bin_width * start_bin
    new_max = min_val + bin_width * (end_bin + 1)
    return new_min, new_max


def _upscale_histogram(histogram, orig_min, orig_max, update_min,
                       update_max, bins):
    histogram = np.repeat(histogram, UPSAMPLE_RATE) / UPSAMPLE_RATE
    bin_size = (orig_max - orig_min) / (bins * UPSAMPLE_RATE)
    mid_points = np.linspace(orig_min, orig_max,
                             bins * UPSAMPLE_RATE + 1)[:-1] + 0.5 * bin_size
    boundaries = np.linspace(update_min, update_max, bins + 1)
    assign = np.digitize(mid_points, boundaries, right=False) - 1
    assign = np.clip(assign, 0, bins - 1)
    return np.bincount(assign, weights=histogram, minlength=bins)


def static_hist_range(
    batches: Sequence, spec: QuantSpec, bins: int = 2048
) -> Tuple[float, float]:
    """Accumulate a histogram over calib batches then search the optimal
    clipping threshold (quant.py:462-522)."""
    if not (spec.symmetric and spec.granularity == "per_tensor"):
        raise ValueError("static_hist supports per-tensor symmetric only")
    histogram = np.zeros(bins)
    min_val = max_val = None
    for b in batches:
        arr = _numpy(b).ravel()
        x_min, x_max = float(arr.min()), float(arr.max())
        if min_val is None:
            histogram, _ = np.histogram(arr, bins=bins, range=(x_min, x_max))
            histogram = histogram.astype(np.float64)
            min_val, max_val = x_min, x_max
        else:
            new_min, new_max = min(min_val, x_min), max(max_val, x_max)
            update_hist, _ = np.histogram(arr, bins=bins,
                                          range=(new_min, new_max))
            update_hist = update_hist.astype(np.float64)
            if new_min == min_val and new_max == max_val:
                histogram += update_hist
            else:
                if min_val != max_val:
                    histogram = _upscale_histogram(
                        histogram, min_val, max_val, new_min, new_max, bins
                    )
                histogram = histogram + update_hist
            min_val, max_val = new_min, new_max
    return _hist_threshold(histogram, min_val, max_val, bins, spec.dst_nbins)
