// coord_stat for 32-row register capacity, float input: K1's
// plain and K5's masked instance (one translation unit per capacity
// and dtype: they compile in parallel).
#include "coord_stat.cuh"

template void coord_stat_launch<32, float, false>(
    const void*, const float*, float*, int, long long, long long, int, int,
    cudaStream_t);
template void coord_stat_launch<32, float, true>(
    const void*, const float*, float*, int, long long, long long, int, int,
    cudaStream_t);
