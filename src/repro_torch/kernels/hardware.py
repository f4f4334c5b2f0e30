"""Peak rates of the NVIDIA H100 SXM: the denominators of the bounds the
port reports beside its kernel times (a kernel's bound is the larger of
its bytes over the memory rate and its operations over the peak rate of
their type)."""

HBM_BYTES_PER_S = 3.35e12      # device memory (HBM3)
BF16_FLOPS_PER_S = 989e12      # dense tensor-core bfloat16
# no int32 XOR rate is published: the float32 rate outside the tensor
# cores stands in (the XOR kernel is bound by memory anyway)
INT32_OPS_PER_S = 67e12
