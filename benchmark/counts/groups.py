"""Device kernels by name: the port's kernels and the largest other groups,
copied from ``chip_smoke.py:PROFILE_GROUPS`` (l.2172). The first group whose key
a kernel's name contains takes it."""

PROFILE_GROUPS = (
    ("K3 dense_attn_*kernel", ("dense_attn_kernel", "dense_attn_wg_kernel")),
    ("K3b dense_attn_bwd_*", ("dense_attn_bwd_",)),
    # before K1's and cuBLAS's groups: their keys would take K6b's kernels too
    ("K6b knn_bwd_*", ("knn_bwd_",)),
    ("K1 (K6 fwd) knn_select + core", ("knn_select_kernel", "vector_attn_kernel",
                                        "core_gemm_kernel")),
    ("K7 scatter_*", ("scatter_",)),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "Conv", "implicit")),
    ("gemm (cuBLAS / cuDNN)", ("gemm", "Gemm", "sm90_xmma", "cutlass")),
    ("group norm", ("group_norm", "GroupNorm", "groupnorm")),
    ("layout (NCHW <-> NHWC)", ("nchwToNhwc", "nhwcToNchw")),
    ("copies and sets", ("Memcpy", "Memset")),
)


def group_of(name: str) -> str:
    """The group label of a device operation, or its own name (cut to 80
    characters) where no group takes it."""
    for label, keys in PROFILE_GROUPS:
        if any(k in name for k in keys):
            return label
    return name[:80]
