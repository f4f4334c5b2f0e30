"""Peak rates of the NVIDIA H100 SXM: the denominators of the bounds the
port reports beside its kernel times (a kernel's bound is the largest of
its bytes over the memory rate, its operations over the peak rate of
their type and, for attention, its exponentials over the rate of the
special function units)."""

HBM_BYTES_PER_S = 3.35e12      # device memory (HBM3)
BF16_FLOPS_PER_S = 989e12      # dense tensor-core bfloat16 (and float16)
FP8_FLOPS_PER_S = 1979e12      # dense tensor-core float8 (e4m3, e5m2)
F32_FLOPS_PER_S = 67e12        # float32 FMA outside the tensor cores
# no int32 XOR rate is published: the float32 rate outside the tensor
# cores stands in (the XOR kernel is bound by memory anyway)
INT32_OPS_PER_S = F32_FLOPS_PER_S
SMS = 132                      # streaming multiprocessors of the SXM part
# base-2 exponentials (ex2.approx, MUFU.EX2) an SM completes a clock: the
# CUDA C++ Programming Guide's table "Throughput of Native Arithmetic
# Instructions (Operations per Clock Cycle per Multiprocessor)", compute
# capability 9.0, row "32-bit floating-point reciprocal, reciprocal square
# root, base-2 logarithm (__log2f), base 2 exponential (exp2f), sine
# (__sinf), cosine (__cosf)": 16
EXP2_PER_CLOCK_PER_SM = 16


def exp2_per_s(sm_clock_mhz: float) -> float:
    """The card's base-2 exponentials a second at an SM clock of
    `sm_clock_mhz` (nvidia-smi's clocks.max.sm)."""
    return EXP2_PER_CLOCK_PER_SM * SMS * sm_clock_mhz * 1e6
