// coord_stat for 64-row register capacity, __nv_bfloat16 input: K1's
// plain and K5's masked instance (one translation unit per capacity
// and dtype: they compile in parallel).
#include "coord_stat.cuh"

template void coord_stat_launch<64, __nv_bfloat16, false>(
    const void*, const float*, float*, int, long long, long long, int, int,
    cudaStream_t);
template void coord_stat_launch<64, __nv_bfloat16, true>(
    const void*, const float*, float*, int, long long, long long, int, int,
    cudaStream_t);
