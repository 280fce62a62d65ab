"""spherical_ba: a spherical (360/ERP) structure-from-motion and bundle
adjustment framework in JAX.

Re-designed from scratch for JAX/XLA with the capabilities of
the reference C++ tool whdlgp/spherical_bundle_adjuster: ERP<->cubemap
reprojection, distortion-reduced spherical feature front-ends, descriptor
matching, robust two-view relative pose (8-point RANSAC consensus + BA),
and — beyond the reference — batched multi-pair and distributed
multi-keyframe Schur-complement bundle adjustment over device meshes.
"""

__version__ = "0.1.0"

from .utils.config import PipelineConfig  # noqa: F401
