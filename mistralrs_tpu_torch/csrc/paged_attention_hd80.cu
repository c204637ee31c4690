// The head_dim-80 forms of the paged decode and prefill kernels (bodies in
// paged_attention.cuh; entry points in paged_attention.cu), compiled alone.

#include "paged_attention.cuh"

MRT_PA_INSTANTIATE(80)
