"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates): float32 outside the tensor cores and HBM3 bandwidth; the
special-function rate from the Hopper white paper, 16 results per SM a clock
on 132 SMs at 1.98 GHz.  The port computes in float32 with TF32 off, so its
FLOPs are held against the float32 rate."""
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9
