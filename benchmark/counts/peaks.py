"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full power limit of 700 W)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "bfloat16": 989e12,   # tensor cores
    # float32 outside the tensor cores: the program turns TF32 off
    # (train.py set_float32_precision).
    "float32": 67e12,
}
