// The Bulyan coordinate stage (K13 and K14) for a 32-value register
// capacity, float input (one translation unit per capacity and dtype:
// they compile in parallel).
#include "bulyan_coord.cuh"

template void bulyan_coord_launch<32, float>(
    const void*, const float*, const float*, const void*, float*, int,
    long long, long long, int, int, cudaStream_t);
