"""Render configuration.

Frozen (hashable, jit-static) analog of the reference's `RenderOptions` POD
(ref: include/PathTrace/worker.h:14-31), with two deliberate changes:

* `allow_bias` is honest: the reference declares the flag but never reads it —
  its biased candidate-selection fallback always runs (ref: src/worker.cpp:273
  -317). Here the biased estimator only runs when `allow_bias=True`.
* `max_depth` bounds the wavefront loop. The reference's bounce loop is
  unbounded (ref: src/worker.cpp:44), but its Russian-roulette schedule
  (p <= 0.2 past depth 4) and the 1e-20 `bounce_pd` cutoff guarantee
  termination within ~34 bounces; 64 is a safe static bound for XLA.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    image_width: int
    image_height: int
    min_sample_count: int = 16
    max_sample_count: int = 64
    epsilon: float = 1e-3
    allow_bias: bool = False
    # Device-side knobs (static; affect compilation only, not the estimator).
    max_depth: int = 64
    # Number of samples evaluated per device launch; the film accumulates
    # across launches. 0 = all samples in one launch.
    samples_per_launch: int = 0
    # Primitive count at or below which the dense (brute-force) intersector is
    # used instead of BVH traversal; dense all-pairs intersection needs no
    # traversal at all for small scenes.
    dense_intersect_threshold: int = 128

    def __post_init__(self):
        if self.max_sample_count < self.min_sample_count:
            object.__setattr__(self, "max_sample_count", self.min_sample_count)
