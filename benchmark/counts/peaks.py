"""NVIDIA's published peaks of one H100 SXM (data sheet, dense, no sparsity),
which assume the card's full 700 W; a run prints the card's power limit beside
every share it states."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "fp8": 1979e12, "tf32": 495e12,
              "float32": 67e12}
