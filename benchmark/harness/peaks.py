"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
700 W).  Frozen copy of ``chip_smoke.py``'s table at commit 15258b49d6b0."""

H100_FP32_FLOPS = 67e12      # non-tensor FP32 (an FMA counts as two)
H100_FP64_FLOPS = 34e12      # non-tensor FP64
H100_BYTES_PER_S = 3.35e12   # HBM3
