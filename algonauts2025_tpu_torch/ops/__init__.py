"""Tensor ops of the port; kernels are built from ../csrc on first use."""

from .attention import (
    apply_rotary,
    dot_product_attention,
    fused_attention,
    launch_counts,
    rotary_angles,
)
from .fast_gelu import erf_rational, gelu_fast
from .pearson import PearsonState, compute_pearson, init_pearson_state, pearson_corr, update_pearson_state
from .pooling import adaptive_avg_pool1d, adaptive_avg_pool_matrix

__all__ = [
    "apply_rotary",
    "dot_product_attention",
    "fused_attention",
    "launch_counts",
    "rotary_angles",
    "erf_rational",
    "gelu_fast",
    "PearsonState",
    "compute_pearson",
    "init_pearson_state",
    "pearson_corr",
    "update_pearson_state",
    "adaptive_avg_pool_matrix",
    "adaptive_avg_pool1d",
]
