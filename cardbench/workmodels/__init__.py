"""The yardstick's arithmetic: the operations and bytes of the causal
kernels (``causal``, frozen copies of the program's work models) and the
model operations of a whole step (``flops``), against the H100 SXM's
published peaks (``PEAKS``)."""

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W power limit
PEAKS = {"hbm_bytes_per_s": 3350e9, "bf16_flops_per_s": 989e12,
         "tf32_flops_per_s": 495e12, "fp32_flops_per_s": 67e12}


def peak_flops(cfg: dict) -> float:
    """The peak of a configuration's compute dtype: bf16 on the tensor
    cores, float32 outside them (the program's fp32 runs without TF32)."""
    return PEAKS["bf16_flops_per_s" if cfg["compute_dtype"] == "bfloat16"
                 else "fp32_flops_per_s"]
